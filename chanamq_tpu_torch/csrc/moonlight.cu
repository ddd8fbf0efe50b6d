// The Moonlight backbone's kernels (DeepSeek-V3's block: latent attention,
// sigmoid-routed experts, shared experts) for Hopper (sm_90a), forward and
// backward, each at the rounding points of the plain versions in
// kernels/moonlight.py:
//
// - rmsnorm: y = bf16(w * float(bf16(x * rsqrt(mean(x^2) + eps)))), a
//   warp a row, rows read with a row stride (the key-value latent is the
//   first 512 columns of a 576-wide product); its backward writes dx and
//   each block's partial dw, which a second launch sums in block order
//   (the same inputs give the same bits).
// - mla_qkv: the fused attention operand [R][3][H][192] from the query
//   product (per head 128 plain | 64 rotated columns), the latent's
//   key-value product (per head 128 key | 128 value columns) and the
//   rotated key shared by every head (columns 512..575 of the latent
//   product): the rotary positions on adjacent pairs (the config's
//   rope_interleave), values padded with zeros to 192. Its backward sums
//   the shared key's gradient over the heads and rotates back.
// - swiglu: bf16(bf16(silu(g)) * u) over a gate | up product; backward.
// - route_weights: each token's chosen sigmoid scores, normalised and
//   scaled; backward into the scores.
// - gather_rows / token_sum / combine: the dispatch of each token to its
//   experts' rows (sorted by expert), the sum back of their gradients, and
//   the weighted combine with the shared experts and the residual; the
//   combine's backward.
// - router_product: the router's float32 products (logits and their
//   gradients), tiled in shared memory, split over K where the output is
//   small (the weight's gradient sums over every token).
// - grouped_product: one launch of the products of every expert over rows
//   sorted by expert, the group offsets read on the device (empty and
//   uneven groups, no host sync): forward Y = X W_e, dX = dY W_e^T and
//   dW_e = X_e^T dY_e, bf16 operands summed in float32, rounded once.
//   Tiles of 128 x 128 outputs, 32 deep, on eight warps of WMMA 16x16x16
//   products, fed by a two-stage cp.async ring (zeros past a group's rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 raw;
  bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// -- RMSNorm -----------------------------------------------------------------

constexpr int kRowWarps = 8;
constexpr int kRowThreads = kRowWarps * 32;
constexpr int kNormMaxBlocks = 264;  // two a streaming multiprocessor

// Columns (c * 32 + lane) * 8 .. + 8 of a row are lane's chunk c.
template <int CH>
__global__ void __launch_bounds__(kRowThreads)
    rmsnorm_kernel(const bf16* __restrict__ x, long long ldx,
                   const float* __restrict__ w, bf16* __restrict__ out,
                   long long ldo, int R, float eps) {
  constexpr int D = CH * 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long row = (long long)blockIdx.x * kRowWarps + warp; row < R;
       row += (long long)gridDim.x * kRowWarps) {
    float v[CH][8];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      load8(x + row * ldx + (c * 32 + lane) * 8, v[c]);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = fmaf(v[c][j], v[c][j], ss);
    }
    ss = warp_sum(ss);
    const float r = 1.f / sqrtf(ss / (float)D + eps);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * 32 + lane) * 8;
      float y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = w[col + j] * rb(v[c][j] * r);
      store8(out + row * ldo + col, y);
    }
  }
}

// dx of rows, and this block's partial dw (its rows' sum, the warps added
// in order) into partial[blockIdx.x][D].
template <int CH>
__global__ void __launch_bounds__(kRowThreads)
    rmsnorm_bwd_kernel(const bf16* __restrict__ dy,
                       const bf16* __restrict__ x, long long ldx,
                       const float* __restrict__ w, bf16* __restrict__ dx,
                       long long lddx, float* __restrict__ partial, int R,
                       float eps) {
  constexpr int D = CH * 256;
  __shared__ float red[D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[CH][8];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.f;
  }
  for (long long row = (long long)blockIdx.x * kRowWarps + warp; row < R;
       row += (long long)gridDim.x * kRowWarps) {
    float v[CH][8];
    float ss = 0.f, s = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * 32 + lane) * 8;
      float g[8];
      load8(x + row * ldx + col, v[c]);
      load8(dy + row * D + col, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ss = fmaf(v[c][j], v[c][j], ss);
        s = fmaf(rb(g[j] * w[col + j]), v[c][j], s);
      }
    }
    ss = warp_sum(ss);
    s = warp_sum(s);
    const float r = 1.f / sqrtf(ss / (float)D + eps);
    const float k = r * r * r * s / (float)D;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = (c * 32 + lane) * 8;
      float g[8], out[8];
      load8(dy + row * D + col, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[c][j] = fmaf(g[j], rb(v[c][j] * r), acc[c][j]);
        out[j] = r * rb(g[j] * w[col + j]) - v[c][j] * k;
      }
      store8(dx + row * lddx + col, out);
    }
  }
  for (int i = threadIdx.x; i < D; i += kRowThreads) red[i] = 0.f;
  __syncthreads();
  for (int wp = 0; wp < kRowWarps; ++wp) {
    if (warp == wp) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int j = 0; j < 8; ++j) red[(c * 32 + lane) * 8 + j] += acc[c][j];
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < D; i += kRowThreads) {
    partial[(size_t)blockIdx.x * D + i] = red[i];
  }
}

// dw[i] = the partials' sum over the blocks, in block order.
__global__ void rmsnorm_dw_kernel(const float* __restrict__ partial,
                                  float* __restrict__ dw, int blocks, int D) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * D + i];
  dw[i] = s;
}

// -- latent attention's operands -----------------------------------------------

constexpr int kNope = 128;  // qk_nope_head_dim
constexpr int kRope = 64;   // qk_rope_head_dim
constexpr int kHd = kNope + kRope;  // 192: q and k width
constexpr int kVd = 128;    // v_head_dim
constexpr int kLatent = 512;  // kv_lora_rank
constexpr int kKva = kLatent + kRope;  // 576
constexpr int kHalf = kRope / 2;

// Rotated columns i..i+7 (i a multiple of 8, within 64) of a head whose
// rotated part is src[0..63] (adjacent pairs), at position pos: out[i] =
// bf16(bf16(x'_i cos_i) + bf16(rot(x')_i sin_i)), x' the pairs taken
// apart (evens, then odds), cos and sin bf16 [T][32] each.
__device__ __forceinline__ void rope8(const bf16* src, const bf16* cs,
                                      int pos, int i, float (&out)[8]) {
  const bf16* c = cs + (size_t)pos * kRope;
  const bf16* s = c + kHalf;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int o = i + e;
    const int j = o < kHalf ? o : o - kHalf;
    const float cj = __bfloat162float(c[j]), sj = __bfloat162float(s[j]);
    const float even = __bfloat162float(src[2 * j]);
    const float odd = __bfloat162float(src[2 * j + 1]);
    out[e] = o < kHalf ? rb(rb(even * cj) - rb(odd * sj))
                       : rb(rb(odd * cj) + rb(even * sj));
  }
}

// out [R][3][H][192] in chunks of 8: q (plain | rotated), k (plain |
// shared rotated), v (128 | zeros).
__global__ void mla_qkv_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ kv,
                               const bf16* __restrict__ kva,
                               const bf16* __restrict__ cs,
                               bf16* __restrict__ out, long long R, int T,
                               int H) {
  const long long per_row = 3LL * H * kHd / 8;
  const long long total = R * per_row;
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       n < total; n += (long long)gridDim.x * blockDim.x) {
    const long long row = n / per_row;
    const int rem = (int)(n - row * per_row) * 8;
    const int plane = rem / (H * kHd);
    const int h = (rem / kHd) % H;
    const int col = rem % kHd;
    const int pos = (int)(row % T);
    float v[8];
    if (plane == 0) {
      const bf16* src = q + (row * H + h) * kHd;
      if (col < kNope) {
        load8(src + col, v);
      } else {
        rope8(src + kNope, cs, pos, col - kNope, v);
      }
    } else if (plane == 1) {
      if (col < kNope) {
        load8(kv + (row * H + h) * (kNope + kVd) + col, v);
      } else {
        rope8(kva + row * kKva + kLatent, cs, pos, col - kNope, v);
      }
    } else if (col < kVd) {
      load8(kv + (row * H + h) * (kNope + kVd) + kNope + col, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    store8(out + row * 3 * H * kHd + rem, v);
  }
}

// The rotation's gradient for the pairs of outputs j and 32 + j (j a
// multiple of 4, four pairs): from d (64 rotated gradients), dx[2j] =
// bf16(bf16(d_j cos_j) + bf16(d_{32+j} sin_j)), dx[2j+1] =
// bf16(bf16(d_{32+j} cos_j) - bf16(d_j sin_j)); eight values dx[2j..2j+7].
__device__ __forceinline__ void rope_bwd8(const float* d, const bf16* cs,
                                          int pos, int j0, float (&out)[8]) {
  const bf16* c = cs + (size_t)pos * kRope;
  const bf16* s = c + kHalf;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    const float cj = __bfloat162float(c[j]), sj = __bfloat162float(s[j]);
    out[2 * e] = rb(rb(d[j] * cj) + rb(d[kHalf + j] * sj));
    out[2 * e + 1] = rb(rb(d[kHalf + j] * cj) - rb(d[j] * sj));
  }
}

// dq [R][H][192], dkv [R][H][256], and columns 512..575 of dkva [R][576]
// from dqkv [R][3][H][192]: one thread a row and head (its dq and dkv
// chunks), and the shared key's gradient summed over the heads (h == H
// handles it).
__global__ void mla_qkv_bwd_kernel(const bf16* __restrict__ dqkv,
                                   const bf16* __restrict__ cs,
                                   bf16* __restrict__ dq,
                                   bf16* __restrict__ dkv,
                                   bf16* __restrict__ dkva, long long R,
                                   int T, int H) {
  const long long total = R * (H + 1);
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       n < total; n += (long long)gridDim.x * blockDim.x) {
    const long long row = n / (H + 1);
    const int h = (int)(n - row * (H + 1));
    const int pos = (int)(row % T);
    const bf16* g = dqkv + row * 3 * H * kHd;
    float d[kRope];
    float v[8];
    if (h < H) {
      const bf16* gq = g + h * kHd;
      const bf16* gk = g + (H + h) * kHd;
      const bf16* gv = g + (2 * H + h) * kHd;
      bf16* oq = dq + (row * H + h) * kHd;
      bf16* okv = dkv + (row * H + h) * (kNope + kVd);
      for (int c = 0; c < kNope; c += 8) {
        load8(gq + c, v);
        store8(oq + c, v);
        load8(gk + c, v);
        store8(okv + c, v);
        load8(gv + c, v);
        store8(okv + kNope + c, v);
      }
#pragma unroll
      for (int c = 0; c < kRope; c += 8) {
        load8(gq + kNope + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[c + e] = v[e];
      }
#pragma unroll
      for (int j = 0; j < kHalf; j += 4) {
        rope_bwd8(d, cs, pos, j, v);
        store8(oq + kNope + 2 * j, v);
      }
    } else {
      for (int c = 0; c < kRope; ++c) d[c] = 0.f;
      for (int hh = 0; hh < H; ++hh) {
        const bf16* gk = g + (H + hh) * kHd + kNope;
        for (int c = 0; c < kRope; c += 8) {
          load8(gk + c, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) d[c + e] += v[e];
        }
      }
      for (int c = 0; c < kRope; ++c) d[c] = rb(d[c]);
#pragma unroll
      for (int j = 0; j < kHalf; j += 4) {
        rope_bwd8(d, cs, pos, j, v);
        store8(dkva + row * kKva + kLatent + 2 * j, v);
      }
    }
  }
}

// -- SwiGLU --------------------------------------------------------------------

__device__ __forceinline__ float sigmoid_f(float g) {
  return 1.f / (1.f + expf(-g));
}

// out [R][F] = bf16(bf16(silu(g)) * u), gu [R][2F] = g | u.
__global__ void swiglu_kernel(const bf16* __restrict__ gu,
                              bf16* __restrict__ out, long long R, int F) {
  const long long total = R * (F / 8);
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       n < total; n += (long long)gridDim.x * blockDim.x) {
    const long long row = n / (F / 8);
    const int col = (int)(n - row * (F / 8)) * 8;
    float g[8], u[8], y[8];
    load8(gu + row * 2 * F + col, g);
    load8(gu + row * 2 * F + F + col, u);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = rb(g[e] / (1.f + expf(-g[e]))) * u[e];
    store8(out + row * F + col, y);
  }
}

// dgu [R][2F] from dy [R][F]: ds = bf16(dy u), du = bf16(dy s),
// dg = bf16(ds sig (1 + g (1 - sig))), s = bf16(silu(g)).
__global__ void swiglu_bwd_kernel(const bf16* __restrict__ dy,
                                  const bf16* __restrict__ gu,
                                  bf16* __restrict__ dgu, long long R,
                                  int F) {
  const long long total = R * (F / 8);
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       n < total; n += (long long)gridDim.x * blockDim.x) {
    const long long row = n / (F / 8);
    const int col = (int)(n - row * (F / 8)) * 8;
    float g[8], u[8], d[8], dg[8], du[8];
    load8(gu + row * 2 * F + col, g);
    load8(gu + row * 2 * F + F + col, u);
    load8(dy + row * F + col, d);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float sig = sigmoid_f(g[e]);
      const float s = rb(g[e] / (1.f + expf(-g[e])));
      const float ds = rb(d[e] * u[e]);
      du[e] = d[e] * s;
      dg[e] = ds * sig * (1.f + g[e] * (1.f - sig));
    }
    store8(dgu + row * 2 * F + col, dg);
    store8(dgu + row * 2 * F + F + col, du);
  }
}

// -- routing, dispatch and combine ---------------------------------------------

// weights [R][K] = scale * s_j / (sum_j s_j + 1e-20), s_j the token's
// scores at idx [R][K] (int64), summed in slot order.
__global__ void route_weights_kernel(const float* __restrict__ scores,
                                     const long long* __restrict__ idx,
                                     float* __restrict__ out, int R, int E,
                                     int K, float scale) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float s[16];
  float den = 0.f;
  for (int j = 0; j < K; ++j) {
    s[j] = scores[(size_t)r * E + idx[(size_t)r * K + j]];
    den += s[j];
  }
  den += 1e-20f;
  for (int j = 0; j < K; ++j) out[(size_t)r * K + j] = (s[j] / den) * scale;
}

// dscores [R][E] (zeros off the chosen) from dweights [R][K].
__global__ void route_weights_bwd_kernel(const float* __restrict__ dw,
                                         const float* __restrict__ scores,
                                         const long long* __restrict__ idx,
                                         float* __restrict__ ds, int R,
                                         int E, int K, float scale) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float s[16], dt[16];
  float den = 0.f;
  for (int j = 0; j < K; ++j) {
    s[j] = scores[(size_t)r * E + idx[(size_t)r * K + j]];
    den += s[j];
  }
  den += 1e-20f;
  float dden = 0.f;
  for (int j = 0; j < K; ++j) {
    dt[j] = dw[(size_t)r * K + j] * scale;
    dden += -dt[j] * s[j] / (den * den);
  }
  for (int e = 0; e < E; ++e) ds[(size_t)r * E + e] = 0.f;
  for (int j = 0; j < K; ++j) {
    ds[(size_t)r * E + idx[(size_t)r * K + j]] = dt[j] / den + dden;
  }
}

// out [Rs][D] = x [src[r]] (D a multiple of 8).
__global__ void gather_rows_kernel(const bf16* __restrict__ x,
                                   const int* __restrict__ src,
                                   bf16* __restrict__ out, long long Rs,
                                   int D) {
  const long long total = Rs * (D / 8);
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       n < total; n += (long long)gridDim.x * blockDim.x) {
    const long long r = n / (D / 8);
    const int col = (int)(n - r * (D / 8)) * 8;
    *reinterpret_cast<uint4*>(out + r * D + col) =
        *reinterpret_cast<const uint4*>(x + (long long)src[r] * D + col);
  }
}

// out [T][D] = bf16(sum_j rows[pos[t K + j]]) in float32, slot order.
__global__ void token_sum_kernel(const bf16* __restrict__ rows,
                                 const int* __restrict__ pos,
                                 bf16* __restrict__ out, long long T, int D,
                                 int K) {
  const long long total = T * (D / 8);
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       n < total; n += (long long)gridDim.x * blockDim.x) {
    const long long t = n / (D / 8);
    const int col = (int)(n - t * (D / 8)) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < K; ++j) {
      float v[8];
      load8(rows + (long long)pos[t * K + j] * D + col, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
    }
    store8(out + t * D + col, acc);
  }
}

// out [T][D] = bf16(bf16(bf16(m) + shared) + residual), m = sum over the
// token's slots (slot order: its experts ascending) of float32 w * y,
// each product and sum rounded to float32 (no fused multiply-add), as
// the modeling file's float32 index_add_ over the experts in turn.
__global__ void combine_kernel(const bf16* __restrict__ ys,
                               const float* __restrict__ w,
                               const int* __restrict__ pos,
                               const bf16* __restrict__ shared,
                               const bf16* __restrict__ residual,
                               bf16* __restrict__ out, long long T, int D,
                               int K) {
  const long long total = T * (D / 8);
  for (long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       n < total; n += (long long)gridDim.x * blockDim.x) {
    const long long t = n / (D / 8);
    const int col = (int)(n - t * (D / 8)) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < K; ++j) {
      const float wj = w[t * K + j];
      float v[8];
      load8(ys + (long long)pos[t * K + j] * D + col, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(v[e], wj));
    }
    float sh[8], res[8];
    load8(shared + t * D + col, sh);
    load8(residual + t * D + col, res);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = rb(rb(rb(acc[e]) + sh[e]) + res[e]);
    store8(out + t * D + col, acc);
  }
}

// The combine's backward: a warp a (token, slot). dys [pos] = bf16(w *
// dout), dw [t][j] = sum over columns of dout * y (float32).
__global__ void combine_bwd_kernel(const bf16* __restrict__ dout,
                                   const bf16* __restrict__ ys,
                                   const float* __restrict__ w,
                                   const int* __restrict__ pos,
                                   bf16* __restrict__ dys,
                                   float* __restrict__ dw, long long T,
                                   int D, int K) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long n = (long long)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       n < T * K; n += warps) {
    const long long t = n / K;
    const long long p = pos[n];
    const float wj = w[n];
    float dot = 0.f;
    for (int col = lane * 8; col < D; col += 256) {
      float g[8], y[8], o[8];
      load8(dout + t * D + col, g);
      load8(ys + p * D + col, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dot = fmaf(g[e], y[e], dot);
        o[e] = wj * g[e];
      }
      store8(dys + p * D + col, o);
    }
    dot = warp_sum(dot);
    if (lane == 0) dw[n] = dot;
  }
}

// -- grouped products ------------------------------------------------------------

namespace grouped {

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;  // eight warps: 2 (rows) x 4 (columns)
constexpr int kPad = 8;
constexpr int kTileElems = 128 * (32 + kPad) > 32 * (128 + kPad)
                               ? 128 * (32 + kPad)
                               : 32 * (128 + kPad);  // 5,120
constexpr int kStageElems = 2 * kTileElems;  // A and B

enum Layout { kNN = 0, kNT = 1, kTN = 2 };

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace grouped

// NN: Y [Rs][N] = X_g W_e, X [Rs][K] sorted by expert, W [E][K][N].
// NT: dX [Rs][N] = dY_g W_e^T, dY [Rs][K], W [E][N][K] (its [in][out]
//     layout: out = N of this call is W's rows), the sum over K.
// TN: dW [E][M][N] = X_e^T dY_e, X [Rs][M], dY [Rs][N], the sum over the
//     group's rows.
// offsets [E + 1] (int32, on the device) bound each expert's rows. TN's
// block row y takes expert order[y] (the experts by falling row count), so
// the blocks of the largest groups, which walk the most rows, start first
// and do not trail the grid; each output tile's sum is the same whatever
// the order.
template <int L>
__global__ void __launch_bounds__(grouped::kThreads)
    grouped_product_kernel(const bf16* __restrict__ A,
                           const bf16* __restrict__ B,
                           bf16* __restrict__ C,
                           const int* __restrict__ offsets,
                           const int* __restrict__ order, int E, int M,
                           int N, int K) {
  using namespace grouped;
  using namespace nvcuda;
  __shared__ __align__(128) bf16 smem[2 * kStageElems];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // 64 rows x 32 columns a warp
  int e, g0, g1, m0, n0;
  if (L == kTN) {
    e = order[blockIdx.y];
    g0 = offsets[e];
    g1 = offsets[e + 1];
    const int tiles_n = N / kBN;
    m0 = (blockIdx.x / tiles_n) * kBM;
    n0 = (blockIdx.x % tiles_n) * kBN;
  } else {
    int t = blockIdx.y;
    e = -1;
    for (int i = 0; i < E; ++i) {
      const int a = offsets[i], b = offsets[i + 1];
      const int tiles = (b - a + kBM - 1) / kBM;
      if (t < tiles) {
        e = i;
        g0 = a;
        g1 = b;
        break;
      }
      t -= tiles;
    }
    if (e < 0) return;
    m0 = g0 + t * kBM;  // the tile's first row
    n0 = blockIdx.x * kBN;
  }
  const int steps = L == kTN ? (g1 - g0 + kBK - 1) / kBK : K / kBK;
  const bf16* Bw = L == kTN ? B : B + (size_t)e * K * N;

  // stage s: A at smem + s * kStageElems, B after it
  auto load = [&](int s, int k0) {
    bf16* As = smem + s * kStageElems;
    bf16* Bs = As + kTileElems;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + i * kThreads;  // 512 chunks of 8
      if (L == kTN) {
        // A^T: [kBK rows of the group][kBM columns of X]
        const int k = c / 16, m = (c % 16) * 8;
        const int row = g0 + k0 + k;
        const bool ok = row < g1;
        cp16(As + k * (kBM + kPad) + m,
             ok ? A + (size_t)row * M + m0 + m : A, ok);
        cp16(Bs + k * (kBN + kPad) + m,
             ok ? B + (size_t)row * N + n0 + m : B, ok);
      } else {
        // A: [kBM rows][kBK]
        const int r = c / 4, k = (c % 4) * 8;
        const int row = m0 + r;
        const bool ok = row < g1;
        cp16(As + r * (kBK + kPad) + k,
             ok ? A + (size_t)row * K + k0 + k : A, ok);
        if (L == kNN) {  // B: [kBK][kBN] of W_e [K][N]
          const int kb = c / 16, n = (c % 16) * 8;
          cp16(Bs + kb * (kBN + kPad) + n,
               Bw + (size_t)(k0 + kb) * N + n0 + n, true);
        } else {  // B^T: [kBN][kBK] of W_e [N][K]
          const int n = c / 4, kb = (c % 4) * 8;
          cp16(Bs + n * (kBK + kPad) + kb,
               Bw + (size_t)(n0 + n) * K + k0 + kb, true);
        }
      }
    }
  };

  using ALayout = typename std::conditional<L == kTN, wmma::col_major,
                                            wmma::row_major>::type;
  using BLayout = typename std::conditional<L == kNT, wmma::col_major,
                                            wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }
  if (steps > 0) load(0, 0);
  commit();
  for (int st = 0; st < steps; ++st) {
    if (st + 1 < steps) load((st + 1) & 1, (st + 1) * kBK);
    commit();
    wait_group<1>();
    __syncthreads();
    const bf16* As = smem + (st & 1) * kStageElems;
    const bf16* Bs = As + kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + i * 16;
        if (L == kTN) {
          wmma::load_matrix_sync(a[i], As + kk * (kBM + kPad) + m,
                                 kBM + kPad);
        } else {
          wmma::load_matrix_sync(a[i], As + m * (kBK + kPad) + kk,
                                 kBK + kPad);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        if (L == kNT) {
          wmma::load_matrix_sync(b[j], Bs + n * (kBK + kPad) + kk,
                                 kBK + kPad);
        } else {
          wmma::load_matrix_sync(b[j], Bs + kk * (kBN + kPad) + n,
                                 kBN + kPad);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                    acc[i][j]);
      }
    }
    __syncthreads();
  }
  wait_group<0>();
  __syncthreads();
  // the epilogue: each warp stages a 16 x 16 float tile at a time
  float* stage = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 64 + i * 16 + r;
      const int col = n0 + wn * 32 + j * 16 + c8;
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = stage[r * 16 + c8 + q];
      if (L == kTN) {
        store8(C + ((size_t)e * M + row) * N + col, v);
      } else if (row < g1) {
        store8(C + (size_t)row * N + col, v);
      }
      __syncwarp();
    }
  }
}

// -- the router's float32 products -------------------------------------------
//
// C [M][N] = op(A) op(B) in float32 (fused multiply-adds, no TF32): the
// router's logits (nn: x [R][D] times its weight [D][E]) and their
// gradients (nt: dX = dL W^T, W stored [D][E] read as [N][K]; tn: dW =
// x^T dL, x stored [R][D] read as [K][M]). 64 x 64 outputs a block of 256
// threads, 4 x 4 a thread, K 16 deep a stage in shared memory; any M, N,
// K (zeros past the edges). With `splits` > 1 block z takes the z-th of
// `splits` contiguous runs of K and writes its partial tile to
// partial[z]; router_sum_kernel adds the partials in order.

namespace rt {
constexpr int kB = 64, kK = 16, kThreads = 256;
}

template <int L>
__global__ void __launch_bounds__(rt::kThreads)
    router_product_kernel(const float* __restrict__ A,
                          const float* __restrict__ B, float* __restrict__ C,
                          int M, int N, int K, int k_run) {
  using namespace rt;
  __shared__ float As[kK][kB + 4];
  __shared__ float Bs[kK][kB + 4];
  const int m0 = blockIdx.y * kB, n0 = blockIdx.x * kB;
  const int k_begin = blockIdx.z * k_run;
  const int k_end = min(K, k_begin + k_run);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += kK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = threadIdx.x + i * kThreads;  // 1,024 of each tile
      // A's tile as [k][m], B's as [k][n]
      int kk, mm;
      if (L == 2) {  // A stored [K][M]: m fastest
        kk = e / kB;
        mm = e % kB;
      } else {  // A stored [M][K]: k fastest
        mm = e / kK;
        kk = e % kK;
      }
      const int gk = k0 + kk, gm = m0 + mm;
      As[kk][mm] = (gk < k_end && gm < M)
                       ? (L == 2 ? A[(size_t)gk * M + gm]
                                 : A[(size_t)gm * K + gk])
                       : 0.f;
      int kb, nn;
      if (L == 1) {  // B stored [N][K]: k fastest
        nn = e / kK;
        kb = e % kK;
      } else {  // B stored [K][N]: n fastest
        kb = e / kB;
        nn = e % kB;
      }
      const int gkb = k0 + kb, gn = n0 + nn;
      Bs[kb][nn] = (gkb < k_end && gn < N)
                       ? (L == 1 ? B[(size_t)gn * K + gkb]
                                 : B[(size_t)gkb * N + gn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* out = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

__global__ void router_sum_kernel(const float* __restrict__ partial,
                                  float* __restrict__ C, long long MN,
                                  int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * MN + i];
  C[i] = s;
}

}  // namespace

extern "C" {

// layout 0 (nn), 1 (nt), 2 (tn) as router_product_kernel; `splits` runs
// of K, each a multiple of 16, into partial [splits][M][N] (unused at 1)
// and then C. One launch, two with splits > 1.
int chana_router_product(const void* A, const void* B, void* C,
                         void* partial, int M, int N, int K, int layout,
                         int splits, void* stream) {
  using namespace rt;
  if (M <= 0 || N <= 0 || K <= 0 || layout < 0 || layout > 2 ||
      splits < 1 || splits > 64 || (splits > 1 && partial == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int k_run = ((K + splits - 1) / splits + kK - 1) / kK * kK;
  const dim3 grid((N + kB - 1) / kB, (M + kB - 1) / kB, splits);
  float* out = splits > 1 ? (float*)partial : (float*)C;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto* a = (const float*)A;
  const auto* b = (const float*)B;
  if (layout == 0) {
    router_product_kernel<0><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K,
                                                       k_run);
  } else if (layout == 1) {
    router_product_kernel<1><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K,
                                                       k_run);
  } else {
    router_product_kernel<2><<<grid, kThreads, 0, s>>>(a, b, out, M, N, K,
                                                       k_run);
  }
  if (splits > 1) {
    const long long mn = (long long)M * N;
    router_sum_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(
        (const float*)partial, (float*)C, mn, splits);
  }
  return (int)cudaGetLastError();
}

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// (0 = launched). The Python wrapper (kernels/moonlight.py) checks dtypes,
// shapes, contiguity and alignment; the checks here refuse what the
// kernels cannot take.

static unsigned grid_for(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

int chana_rmsnorm_blocks(int R) {
  const int need = (R + kRowWarps - 1) / kRowWarps;
  return need < kNormMaxBlocks ? need : kNormMaxBlocks;
}

typedef void (*RmsFn)(const bf16*, long long, const float*, bf16*,
                      long long, int, float);
typedef void (*RmsBwdFn)(const bf16*, const bf16*, long long, const float*,
                         bf16*, long long, float*, int, float);

static bool rms_fns(int D, RmsFn* f, RmsBwdFn* b) {
  switch (D) {
    case 256: *f = rmsnorm_kernel<1>; *b = rmsnorm_bwd_kernel<1>; return true;
    case 512: *f = rmsnorm_kernel<2>; *b = rmsnorm_bwd_kernel<2>; return true;
    case 1024: *f = rmsnorm_kernel<4>; *b = rmsnorm_bwd_kernel<4>; return true;
    case 2048: *f = rmsnorm_kernel<8>; *b = rmsnorm_bwd_kernel<8>; return true;
    default: return false;
  }
}

// x rows ldx apart (D of them normalised), out [R][D] rows ldo apart.
int chana_rmsnorm(const void* x, long long ldx, const void* w, void* out,
                  long long ldo, int R, int D, float eps, void* stream) {
  RmsFn f;
  RmsBwdFn b;
  if (R <= 0 || !rms_fns(D, &f, &b) || ldx < D || ldo < D) {
    return (int)cudaErrorInvalidValue;
  }
  f<<<chana_rmsnorm_blocks(R), kRowThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, ldx, (const float*)w, (bf16*)out, ldo, R, eps);
  return (int)cudaGetLastError();
}

// dy [R][D]; dx rows lddx apart; partial [blocks][D] float32 scratch; dw
// [D] float32. Two launches.
int chana_rmsnorm_bwd(const void* dy, const void* x, long long ldx,
                      const void* w, void* dx, long long lddx, void* partial,
                      void* dw, int R, int D, float eps, void* stream) {
  RmsFn f;
  RmsBwdFn b;
  if (R <= 0 || !rms_fns(D, &f, &b) || ldx < D || lddx < D) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = chana_rmsnorm_blocks(R);
  const cudaStream_t s = (cudaStream_t)stream;
  b<<<blocks, kRowThreads, 0, s>>>((const bf16*)dy, (const bf16*)x, ldx,
                                   (const float*)w, (bf16*)dx, lddx,
                                   (float*)partial, R, eps);
  rmsnorm_dw_kernel<<<(D + 255) / 256, 256, 0, s>>>(
      (const float*)partial, (float*)dw, blocks, D);
  return (int)cudaGetLastError();
}

int chana_mla_qkv(const void* q, const void* kv, const void* kva,
                  const void* cs, void* out, long long R, int T, int H,
                  void* stream) {
  if (R <= 0 || T <= 0 || H <= 0 || R % T != 0) {
    return (int)cudaErrorInvalidValue;
  }
  mla_qkv_kernel<<<grid_for(R * 3 * H * kHd / 8, 256), 256, 0,
                   (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)kv, (const bf16*)kva, (const bf16*)cs,
      (bf16*)out, R, T, H);
  return (int)cudaGetLastError();
}

int chana_mla_qkv_bwd(const void* dqkv, const void* cs, void* dq, void* dkv,
                      void* dkva, long long R, int T, int H, void* stream) {
  if (R <= 0 || T <= 0 || H <= 0 || R % T != 0) {
    return (int)cudaErrorInvalidValue;
  }
  mla_qkv_bwd_kernel<<<grid_for(R * (H + 1), 128), 128, 0,
                       (cudaStream_t)stream>>>(
      (const bf16*)dqkv, (const bf16*)cs, (bf16*)dq, (bf16*)dkv,
      (bf16*)dkva, R, T, H);
  return (int)cudaGetLastError();
}

int chana_swiglu(const void* gu, void* out, long long R, int F,
                 void* stream) {
  if (R <= 0 || F <= 0 || F % 8) return (int)cudaErrorInvalidValue;
  swiglu_kernel<<<grid_for(R * (F / 8), 256), 256, 0,
                  (cudaStream_t)stream>>>((const bf16*)gu, (bf16*)out, R, F);
  return (int)cudaGetLastError();
}

int chana_swiglu_bwd(const void* dy, const void* gu, void* dgu, long long R,
                     int F, void* stream) {
  if (R <= 0 || F <= 0 || F % 8) return (int)cudaErrorInvalidValue;
  swiglu_bwd_kernel<<<grid_for(R * (F / 8), 256), 256, 0,
                      (cudaStream_t)stream>>>((const bf16*)dy,
                                              (const bf16*)gu, (bf16*)dgu,
                                              R, F);
  return (int)cudaGetLastError();
}

int chana_route_weights(const void* scores, const void* idx, void* out,
                        int R, int E, int K, float scale, void* stream) {
  if (R <= 0 || E <= 0 || K <= 0 || K > 16 || K > E) {
    return (int)cudaErrorInvalidValue;
  }
  route_weights_kernel<<<(R + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (const long long*)idx, (float*)out, R, E, K,
      scale);
  return (int)cudaGetLastError();
}

int chana_route_weights_bwd(const void* dw, const void* scores,
                            const void* idx, void* ds, int R, int E, int K,
                            float scale, void* stream) {
  if (R <= 0 || E <= 0 || K <= 0 || K > 16 || K > E) {
    return (int)cudaErrorInvalidValue;
  }
  route_weights_bwd_kernel<<<(R + 127) / 128, 128, 0,
                             (cudaStream_t)stream>>>(
      (const float*)dw, (const float*)scores, (const long long*)idx,
      (float*)ds, R, E, K, scale);
  return (int)cudaGetLastError();
}

int chana_gather_rows(const void* x, const void* src, void* out,
                      long long Rs, int D, void* stream) {
  if (Rs <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<<<grid_for(Rs * (D / 8), 256), 256, 0,
                       (cudaStream_t)stream>>>((const bf16*)x,
                                               (const int*)src, (bf16*)out,
                                               Rs, D);
  return (int)cudaGetLastError();
}

int chana_token_sum(const void* rows, const void* pos, void* out,
                    long long T, int D, int K, void* stream) {
  if (T <= 0 || D <= 0 || D % 8 || K <= 0) return (int)cudaErrorInvalidValue;
  token_sum_kernel<<<grid_for(T * (D / 8), 256), 256, 0,
                     (cudaStream_t)stream>>>((const bf16*)rows,
                                             (const int*)pos, (bf16*)out, T,
                                             D, K);
  return (int)cudaGetLastError();
}

int chana_combine(const void* ys, const void* w, const void* pos,
                  const void* shared, const void* residual, void* out,
                  long long T, int D, int K, void* stream) {
  if (T <= 0 || D <= 0 || D % 8 || K <= 0) return (int)cudaErrorInvalidValue;
  combine_kernel<<<grid_for(T * (D / 8), 256), 256, 0,
                   (cudaStream_t)stream>>>(
      (const bf16*)ys, (const float*)w, (const int*)pos,
      (const bf16*)shared, (const bf16*)residual, (bf16*)out, T, D, K);
  return (int)cudaGetLastError();
}

int chana_combine_bwd(const void* dout, const void* ys, const void* w,
                      const void* pos, void* dys, void* dw, long long T,
                      int D, int K, void* stream) {
  if (T <= 0 || D <= 0 || D % 8 || K <= 0) return (int)cudaErrorInvalidValue;
  combine_bwd_kernel<<<grid_for(T * K * 32, 256), 256, 0,
                       (cudaStream_t)stream>>>(
      (const bf16*)dout, (const bf16*)ys, (const float*)w, (const int*)pos,
      (bf16*)dys, (float*)dw, T, D, K);
  return (int)cudaGetLastError();
}

// layout 0 (NN): A = X [Rs][K], B = W [E][K][N], C = Y [Rs][N];
// 1 (NT): A = dY [Rs][K], B = W [E][N][K], C = dX [Rs][N];
// 2 (TN): A = X [Rs][M], B = dY [Rs][N], C = dW [E][M][N], `order` [E]
// (int32, on the device) the experts in the order their blocks start.
// N a multiple of 128, K (M for TN) a multiple of 32 (128 for TN).
int chana_grouped_product(const void* A, const void* B, void* C,
                          const void* offsets, const void* order, int E,
                          int Rs, int M, int N, int K, int layout,
                          void* stream) {
  using namespace grouped;
  if (E <= 0 || Rs < 0 || N <= 0 || N % kBN || layout < kNN ||
      layout > kTN || (layout == kTN && order == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (layout == kTN) {
    if (M <= 0 || M % kBM) return (int)cudaErrorInvalidValue;
    const dim3 grid((M / kBM) * (N / kBN), E);
    grouped_product_kernel<kTN><<<grid, kThreads, 0, s>>>(
        (const bf16*)A, (const bf16*)B, (bf16*)C, (const int*)offsets,
        (const int*)order, E, M, N, K);
  } else {
    if (K <= 0 || K % kBK) return (int)cudaErrorInvalidValue;
    const dim3 grid(N / kBN, (Rs + kBM - 1) / kBM + E);
    if (layout == kNN) {
      grouped_product_kernel<kNN><<<grid, kThreads, 0, s>>>(
          (const bf16*)A, (const bf16*)B, (bf16*)C, (const int*)offsets,
          nullptr, E, M, N, K);
    } else {
      grouped_product_kernel<kNT><<<grid, kThreads, 0, s>>>(
          (const bf16*)A, (const bf16*)B, (bf16*)C, (const int*)offsets,
          nullptr, E, M, N, K);
    }
  }
  return (int)cudaGetLastError();
}

const char* chana_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
