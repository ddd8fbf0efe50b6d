// Router match kernels for Hopper (sm_90a): topic and headers.
//
// What they replace. chanamq_tpu/router/compile.py::_topic_kernel and
// ::_headers_kernel, the two XLA-jitted programs that route_batch runs for
// every kernel batch of a topic or headers exchange. Each evaluates a match
// predicate for every (message b, binding row n) pair and ORs the queue
// bitmask rows masks[n, :] of the matched rows into out[b, :].
//
// What bounds them on this card. Integer compares and ORs, not bytes: at
// the router's caps (N=512 rows, W=128 mask words, P=S=8 topic tokens) one
// message costs up to N*(P+S+2) = 9,216 compares against 32 KB of token
// tables that stay in L1/L2 after the first blocks, plus W ORs per matched
// row; the whole table set is ~290 KB, read from device memory about once.
// The int32 rate (no tensor-core path for compares) is the roof.
//
// What the design does about it. One block per message. The message's
// tokens (or header pair ids) are staged once in shared memory, so every
// compare reads one table cell from cache and one shared word. Phase 1:
// threads stride over the N rows, evaluate the predicate with an early exit
// on the first failing cell, and append matched row indices to a shared
// list, so phase 2 touches only matched rows (about 4 of 512 on the main
// path) instead of all N. Phase 2 (shared by both kernels): threads stride
// over the W mask words, so each matched mask row is read coalesced, and
// the OR is kept in a register and written once. Rows are processed in
// chunks of CHUNK so any N works. Nothing of shape [B,N,P] or [B,N,W] is
// ever materialised in device memory (the reference's jnp body builds
// both: 268 MB at B=1024, N=512, W=128).
//
// This is the first, simple design: no tiling of several messages per
// block, no vectorised loads, no persistent blocks.
//
// Encoding (same as compile.py): pattern cells STAR=-1 and PAD=-2 match any
// position; message cells MISS=-3 never equal a literal id. Masks are int32
// bit patterns of the reference's uint32 words.

#include <cuda_runtime.h>

#define CHANA_PAD (-2)
#define CHANA_MAX_TOKENS 32  // compile.py MAX_PATTERN_WORDS
#define CHANA_CHUNK 1024
#define CHANA_THREADS 128

namespace {

// Phase 2: out_row[w] (|)= OR of masks[hits[i], w] over the nhit matched
// rows. first=true starts from zero (first chunk of rows); later chunks OR
// into what earlier ones wrote. Each w belongs to one thread, so the
// read-modify-write of out_row has no race.
__device__ __forceinline__ void or_matched_rows(
    const int* __restrict__ masks, const int* hits, int nhit, int W,
    int* __restrict__ out_row, bool first) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    int acc = first ? 0 : out_row[w];
    for (int i = 0; i < nhit; ++i) {
      acc |= masks[(size_t)hits[i] * W + w];
    }
    out_row[w] = acc;
  }
}

__global__ void __launch_bounds__(CHANA_THREADS) topic_match_kernel(
    const int* __restrict__ pre, const int* __restrict__ suf,
    const int* __restrict__ plen, const int* __restrict__ slen,
    const unsigned char* __restrict__ has_hash,
    const int* __restrict__ masks, const int* __restrict__ pre_m,
    const int* __restrict__ suf_m, const int* __restrict__ mlen,
    int* __restrict__ out, int N, int P, int S, int W) {
  __shared__ int s_pre[CHANA_MAX_TOKENS];
  __shared__ int s_suf[CHANA_MAX_TOKENS];
  __shared__ int s_hits[CHANA_CHUNK];
  __shared__ int s_nhit;
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    s_pre[j] = pre_m[(size_t)b * P + j];
  }
  for (int j = threadIdx.x; j < S; j += blockDim.x) {
    s_suf[j] = suf_m[(size_t)b * S + j];
  }
  const int m = mlen[b];
  int* out_row = out + (size_t)b * W;
  for (int base = 0; base < N; base += CHANA_CHUNK) {
    if (threadIdx.x == 0) s_nhit = 0;
    // publishes the staged tokens (first pass) and the counter reset
    __syncthreads();
    const int end = min(base + CHANA_CHUNK, N);
    for (int n = base + threadIdx.x; n < end; n += blockDim.x) {
      bool ok = has_hash[n] ? (m >= plen[n] + slen[n]) : (m == plen[n]);
      const int* prow = pre + (size_t)n * P;
      for (int j = 0; ok && j < P; ++j) {
        const int c = prow[j];
        ok = c < 0 || c == s_pre[j];
      }
      const int* srow = suf + (size_t)n * S;
      for (int j = 0; ok && j < S; ++j) {
        const int c = srow[j];
        ok = c < 0 || c == s_suf[j];
      }
      if (ok) s_hits[atomicAdd(&s_nhit, 1)] = n;
    }
    __syncthreads();
    or_matched_rows(masks, s_hits, s_nhit, W, out_row, base == 0);
    // every thread has read s_nhit/s_hits before the next reset
    __syncthreads();
  }
}

__global__ void __launch_bounds__(CHANA_THREADS) headers_match_kernel(
    const int* __restrict__ req, const int* __restrict__ rcount,
    const unsigned char* __restrict__ is_all,
    const int* __restrict__ masks, const int* __restrict__ pids,
    int* __restrict__ out, int N, int R, int H, int W) {
  extern __shared__ int s_pids[];  // H message pair ids
  __shared__ int s_hits[CHANA_CHUNK];
  __shared__ int s_nhit;
  const int b = blockIdx.x;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    s_pids[j] = pids[(size_t)b * H + j];
  }
  int* out_row = out + (size_t)b * W;
  for (int base = 0; base < N; base += CHANA_CHUNK) {
    if (threadIdx.x == 0) s_nhit = 0;
    __syncthreads();
    const int end = min(base + CHANA_CHUNK, N);
    for (int n = base + threadIdx.x; n < end; n += blockDim.x) {
      // count the row's required pair ids present in the message; PAD
      // cells are not requirements
      const int* rrow = req + (size_t)n * R;
      int cnt = 0;
      for (int r = 0; r < R; ++r) {
        const int c = rrow[r];
        if (c == CHANA_PAD) continue;
        for (int h = 0; h < H; ++h) {
          if (s_pids[h] == c) {
            ++cnt;
            break;
          }
        }
      }
      const bool ok = is_all[n] ? (cnt == rcount[n]) : (cnt > 0);
      if (ok) s_hits[atomicAdd(&s_nhit, 1)] = n;
    }
    __syncthreads();
    or_matched_rows(masks, s_hits, s_nhit, W, out_row, base == 0);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// (0 = launched). Shapes are validated by the Python wrapper; the checks
// here only refuse what the kernel's static shared memory cannot hold.

int chana_topic_match(const void* pre, const void* suf, const void* plen,
                      const void* slen, const void* has_hash,
                      const void* masks, const void* pre_m,
                      const void* suf_m, const void* mlen, void* out, int B,
                      int N, int P, int S, int W, void* stream) {
  if (B <= 0 || N <= 0 || W <= 0 || P < 0 || S < 0 ||
      P > CHANA_MAX_TOKENS || S > CHANA_MAX_TOKENS) {
    return (int)cudaErrorInvalidValue;
  }
  topic_match_kernel<<<B, CHANA_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)pre, (const int*)suf, (const int*)plen, (const int*)slen,
      (const unsigned char*)has_hash, (const int*)masks, (const int*)pre_m,
      (const int*)suf_m, (const int*)mlen, (int*)out, N, P, S, W);
  return (int)cudaGetLastError();
}

int chana_headers_match(const void* req, const void* rcount,
                        const void* is_all, const void* masks,
                        const void* pids, void* out, int B, int N, int R,
                        int H, int W, void* stream) {
  const size_t smem = (size_t)H * sizeof(int);
  if (B <= 0 || N <= 0 || W <= 0 || R < 0 || H < 0 ||
      smem > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  headers_match_kernel<<<B, CHANA_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)req, (const int*)rcount, (const unsigned char*)is_all,
      (const int*)masks, (const int*)pids, (int*)out, N, R, H, W);
  return (int)cudaGetLastError();
}

const char* chana_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
