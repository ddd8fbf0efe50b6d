// Forecaster kernels for Hopper (sm_90a): layernorm, causal attention and
// tanh-GELU, the three non-product steps of the telemetry forecaster's
// forward pass. The products around them (embed, qkv, proj, w1, w2, head)
// stay plain matrix products, as the reference leaves them to XLA.
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
// registers between its two passes (one warp per row, 8 values a lane from
// one 16-byte load); attention reads q, k and v straight out of the fused
// qkv product and writes the [B, T, D] layout the proj product takes, so
// the reference's splits, reshapes and transposes become indexing; GELU is
// one pass of 16-byte loads and stores. This is the first, simple design:
// attention runs one block per (batch, head) on CUDA cores with no tensor
// cores, and nothing is fused across kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CHANA_LN_WARPS 8
#define CHANA_LN_CHUNKS 4  // 16-byte chunks a lane holds: D <= 4 * 256
#define CHANA_ATT_WARPS 8
#define CHANA_GELU_THREADS 256

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// -- layernorm --------------------------------------------------------------
//
// out[r, :] = bf16((x - mean) * rsqrt(var + eps) * scale), float32
// statistics over the row: the mean, then the mean of squared deviations
// from it (two passes over the values held in registers, as the reference
// computes them; not E[x^2] - mean^2). Scale only, no bias. One warp per
// row; lane l holds the 8 values at columns 8 * (32 * c + l).

__global__ void __launch_bounds__(CHANA_LN_WARPS * 32) layernorm_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * CHANA_LN_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;  // whole warps leave together
  const __nv_bfloat16* xr = x + (size_t)row * D;
  float v[CHANA_LN_CHUNKS][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CHANA_LN_CHUNKS; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + col);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = pair_to_float2(w[k]);
        v[c][2 * k] = f.x;
        v[c][2 * k + 1] = f.y;
        sum += f.x + f.y;
      }
    }
  }
  const float mu = warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CHANA_LN_CHUNKS; ++c) {
    if ((c * 32 + lane) * 8 < D) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float d = v[c][k] - mu;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)D + eps);
  __nv_bfloat16* orow = out + (size_t)row * D;
#pragma unroll
  for (int c = 0; c < CHANA_LN_CHUNKS; ++c) {
    const int col = (c * 32 + lane) * 8;
    if (col < D) {
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w[k] = float2_to_pair((v[c][2 * k] - mu) * rstd * scale[col + 2 * k],
                              (v[c][2 * k + 1] - mu) * rstd *
                                  scale[col + 2 * k + 1]);
      }
      *reinterpret_cast<uint4*>(orow + col) = make_uint4(w[0], w[1], w[2],
                                                         w[3]);
    }
  }
}

// -- causal attention -------------------------------------------------------
//
// qkv [B, T, 3D] (q | k | v, head h at columns h * HD of each third) ->
// out [B, T, D], head h at columns h * HD. One block per (b, h): q, k and v
// of the head are staged in shared memory as bf16 pairs with an odd row
// stride, so the 32 lanes that each take one key read 32 different banks.
// Each warp takes query rows i = warp, warp + WARPS, ...; its lanes take
// keys j = lane, lane + 32, ... <= i and compute
//   logit = float(bf16(q_i . k_j)) / sqrt(HD)       (the einsum's bf16 out)
// then the float32 softmax over j <= i (a key past the query would get
// exp(-1e30 - max) = 0 in the reference, so it is skipped, which is exact),
// round each weight to bf16, and accumulate sum_j w_j * v_j in float32 with
// lanes over the head's columns.

__global__ void __launch_bounds__(CHANA_ATT_WARPS * 32)
    causal_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                            __nv_bfloat16* __restrict__ out, int T, int H,
                            int HD, float scale_div) {
  extern __shared__ uint32_t smem[];
  const int hw = HD / 2;                   // bf16 pairs in a head row
  const int ld = (hw % 2 == 0) ? hw + 1 : hw;  // odd stride: no bank clash
  uint32_t* s_q = smem;
  uint32_t* s_k = s_q + T * ld;
  uint32_t* s_v = s_k + T * ld;
  float* s_w = reinterpret_cast<float*>(s_v + T * ld);  // [WARPS][T]
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int D = H * HD;
  const size_t row_words = (size_t)3 * D / 2;  // words in a (b, t) row
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(qkv) + (size_t)b * T * row_words;
  const int per_part = T * hw;
  for (int idx = threadIdx.x; idx < 3 * per_part; idx += blockDim.x) {
    const int part = idx / per_part;  // 0 q, 1 k, 2 v
    const int rem = idx - part * per_part;
    const int t = rem / hw;
    const int c = rem - t * hw;
    smem[part * T * ld + t * ld + c] =
        src[t * row_words + (part * D + h * HD) / 2 + c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* w_row = s_w + warp * T;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out) + (size_t)b * T * (D / 2);
  for (int i = warp; i < T; i += CHANA_ATT_WARPS) {
    const uint32_t* q_i = s_q + i * ld;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j <= i; j += 32) {
      const uint32_t* k_j = s_k + j * ld;
      float acc = 0.f;
      for (int c = 0; c < hw; ++c) {
        const float2 qf = pair_to_float2(q_i[c]);
        const float2 kf = pair_to_float2(k_j[c]);
        acc = fmaf(qf.x, kf.x, acc);
        acc = fmaf(qf.y, kf.y, acc);
      }
      const float logit = round_bf16(acc) / scale_div;
      w_row[j] = logit;
      mx = fmaxf(mx, logit);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(w_row[j] - mx);
      w_row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j <= i; j += 32) {
      w_row[j] = round_bf16(w_row[j] / sum);
    }
    __syncwarp();  // every lane reads every weight below
    for (int c = lane; c < hw; c += 32) {
      float ax = 0.f, ay = 0.f;
      for (int j = 0; j <= i; ++j) {
        const float w = w_row[j];
        const float2 vf = pair_to_float2(s_v[j * ld + c]);
        ax = fmaf(w, vf.x, ax);
        ay = fmaf(w, vf.y, ay);
      }
      dst[(size_t)i * (D / 2) + h * hw + c] = float2_to_pair(ax, ay);
    }
    __syncwarp();  // w_row is rewritten for the warp's next row
  }
}

// -- tanh-GELU --------------------------------------------------------------
//
// out = bf16(x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))) in
// float32, jax.nn.gelu's default (approximate=True) form. Each thread
// takes 8 values with one 16-byte load and store; the tail that does not
// fill 8 values is done one value at a time.

__device__ __forceinline__ float gelu_tanh_f(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  const float cdf = 0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

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

int chana_layernorm(const void* x, const void* scale, void* out, int R,
                    int D, float eps, void* stream) {
  if (R <= 0 || D <= 0 || D % 8 != 0 || D > CHANA_LN_CHUNKS * 256) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (R + CHANA_LN_WARPS - 1) / CHANA_LN_WARPS;
  layernorm_kernel<<<blocks, CHANA_LN_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)scale, (__nv_bfloat16*)out, R, D,
      eps);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the attention kernel needs for T rows of head
// width HD (0 when the shape is refused).
size_t chana_causal_attention_smem(int T, int HD) {
  if (T <= 0 || HD <= 0 || HD % 2 != 0) return 0;
  const int hw = HD / 2;
  const int ld = (hw % 2 == 0) ? hw + 1 : hw;
  return (size_t)(3 * T * ld) * sizeof(uint32_t) +
         (size_t)CHANA_ATT_WARPS * T * sizeof(float);
}

int chana_causal_attention(const void* qkv, void* out, int B, int T, int H,
                           int HD, float scale_div, void* stream) {
  const size_t smem = chana_causal_attention_smem(T, HD);
  if (B <= 0 || H <= 0 || smem == 0 || smem > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        causal_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  causal_attention_kernel<<<B * H, CHANA_ATT_WARPS * 32, smem,
                            (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)qkv, (__nv_bfloat16*)out, T, H, HD, scale_div);
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
