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
// tables that stay in L2 after the first blocks, plus W ORs per matched
// row; the whole table set is ~290 KB, read from device memory about once.
// The int32 rate (no tensor-core path for compares) is the roof, but at
// the main path's batches (16 messages) a call is a few dependent trips to
// L2 and the launch, far above it: the design shortens that chain.
//
// What the design does about it. A block of 512 threads takes MB messages
// (1, 2 or 4; the wrapper picks MB from B) and gives each thread one
// binding row at a time, so N = 512 rows take one pass, and a call waits
// on memory about three times: for its rows and tokens, for the matched
// rows' masks, and to store.
// - Phase 1. The thread reads its row's cells from the transposed tables
//   (pre_t [P, N], suf_t [S, N], req_t [R, N]), which the wrapper uploads
//   once per compiled table: a warp's read of cell j over its 32 rows is
//   one 128-byte line. Every cell is read, 16 loads in flight together and
//   with no early exit, so a warp does not diverge, and the first rows'
//   loads are issued before the block stages its messages; each read cell
//   is compared with all MB messages in shared memory. A headers message
//   is a bitmap of its pair ids in shared memory (ids are dense, so a
//   required id is one bit test, not H compares). Each warp turns its
//   rows' verdicts into one 32-bit word a message with __ballot_sync: the
//   matched rows in row order, with no shared atomics and one barrier.
// - Phase 2 (shared by both kernels). Threads per (message, mask word)
//   walk the set bits of the message's words, eight matched rows at a
//   time, and OR their mask words (a warp's reads coalesced); spare
//   threads split a pair's hit words and meet in shared memory.
// Nothing of shape [B,N,P] or [B,N,W] is ever materialised in device
// memory (the reference's jnp body builds both: 268 MB at B=1024, N=512,
// W=128), and no output needs zeroing: each word is written by one thread.
//
// Encoding (same as compile.py): pattern cells STAR=-1 and PAD=-2 match any
// position; message cells MISS=-3 never equal a literal id. Header pair
// ids are 0 .. vocab-1 and PAD; a message id outside [0, vocab) matches no
// row (the wrapper checks the table's cells once, at upload). Masks are
// int32 bit patterns of the reference's uint32 words.

#include <cuda_runtime.h>

#define CHANA_MAX_TOKENS 32  // compile.py MAX_PATTERN_WORDS
#define CHANA_THREADS 512
#define CHANA_MAX_ROWS 65536  // rows a table may have (hit words in smem)
#define CHANA_MAX_IDS 65536   // pair ids a headers table may have

namespace {

// Phase 1's verdicts of rows [base, base + blockDim) for MB messages: one
// ballot word a warp and message into hit[m * nwords + row / 32] (none
// from a warp whose rows all lie past the table).
template <int MB>
__device__ __forceinline__ void ballot_rows(const bool (&ok)[MB],
                                            unsigned* hit, int nwords,
                                            int n) {
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    const unsigned v = __ballot_sync(0xffffffffu, ok[m]);
    if ((threadIdx.x & 31) == 0 && (n >> 5) < nwords) {
      hit[m * nwords + (n >> 5)] = v;
    }
  }
}

// Phase 2 for one (message, mask word): the OR of masks[r, w] over the
// rows r whose bit is set in the message's hit words k0, k0 + step, ...
// The rows are taken eight at a time and their eight loads issued before
// any of them is used, so a call waits on L2 once for every eight matched
// rows, not once a row.
__device__ __forceinline__ int or_rows(const unsigned* words, int nwords,
                                       int k0, int step,
                                       const int* __restrict__ masks, int W,
                                       int w) {
  int acc = 0;
  int k = k0;
  unsigned bits = k < nwords ? words[k] : 0u;
  while (true) {
    int r[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      while (bits == 0u && (k += step) < nwords) bits = words[k];
      r[u] = bits ? (k << 5) + __ffs(bits) - 1 : -1;
      bits &= bits - 1u;
    }
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      v[u] = r[u] >= 0 ? masks[(size_t)r[u] * W + w] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc |= v[u];
    if (r[7] < 0) return acc;
  }
}

// Phase 2: out[b0 + m, w] = OR of masks[r, w] over the rows r whose bit is
// set in message m's hit words, for the block's nb messages. When the
// block has more threads than (message, word) pairs, `groups` threads
// share a pair, each taking every groups-th hit word, and their ORs meet
// in s_or (zero before the call, one word a pair) with shared atomicOr:
// OR is order-free, so the result is exact and the same every run.
__device__ __forceinline__ void or_hit_rows(const unsigned* hit, int nwords,
                                            const int* __restrict__ masks,
                                            int* __restrict__ out, int b0,
                                            int nb, int W, int* s_or) {
  const int pairs = nb * W;
  const int groups =
      pairs >= (int)blockDim.x ? 1 : min((int)blockDim.x / pairs, nwords);
  if (groups == 1) {
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const int m = i / W;
      const int w = i - m * W;
      out[(size_t)(b0 + m) * W + w] =
          or_rows(hit + m * nwords, nwords, 0, 1, masks, W, w);
    }
    return;
  }
  const int i = threadIdx.x % pairs;
  const int g = threadIdx.x / pairs;
  const int m = i / W;
  const int w = i - m * W;
  if (g < groups) {
    const int acc = or_rows(hit + m * nwords, nwords, g, groups, masks, W, w);
    if (acc != 0) atomicOr(&s_or[i], acc);
  }
  __syncthreads();
  if ((int)threadIdx.x < pairs) out[(size_t)(b0 + m) * W + w] = s_or[i];
}

// Phase 1 reads a row's cells 16 at a time: every load of a batch is
// issued before the first compare.
constexpr int kCellBatch = 16;

// Cells j0 .. j0 + 15 of row n of the transposed tables a [na, N] then
// b [nb, N] (as one row of na + nb cells; -2, PAD, past them).
__device__ __forceinline__ void load_cells(int (&c)[kCellBatch],
                                           const int* __restrict__ a,
                                           int na,
                                           const int* __restrict__ b,
                                           int nb, int N, int n, int j0) {
#pragma unroll
  for (int u = 0; u < kCellBatch; ++u) {
    const int j = j0 + u;
    c[u] = j < na        ? a[(size_t)j * N + n]
           : j < na + nb ? b[(size_t)(j - na) * N + n]
                         : -2;
  }
}

template <int MB>
__global__ void __launch_bounds__(CHANA_THREADS) topic_match_kernel(
    const int* __restrict__ pre_t, const int* __restrict__ suf_t,
    const int* __restrict__ plen, const int* __restrict__ slen,
    const unsigned char* __restrict__ has_hash,
    const int* __restrict__ masks, const int* __restrict__ pre_m,
    const int* __restrict__ suf_m, const int* __restrict__ mlen,
    int* __restrict__ out, int B, int N, int P, int S, int W) {
  __shared__ int s_tok[MB][2 * CHANA_MAX_TOKENS];  // prefix | suffix
  __shared__ int s_len[MB];
  __shared__ int s_or[CHANA_THREADS];
  extern __shared__ unsigned s_hit[];  // [MB][nwords]
  const int b0 = blockIdx.x * MB;
  const int nb = min(MB, B - b0);
  const int nwords = (N + 31) >> 5;
  const int C = P + S;
  // the first rows' lengths and cells, in flight while the tokens are
  // staged
  int pl = 0, need = -1, c[kCellBatch];
  auto load_row = [&](int n) {
    if (n < N) {
      pl = plen[n];
      need = has_hash[n] ? pl + slen[n] : -1;
      load_cells(c, pre_t, P, suf_t, S, N, n, 0);
    }
  };
  load_row(threadIdx.x);
  s_or[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < MB * C; i += blockDim.x) {
    const int m = i / C;
    const int j = i - m * C;
    int v = -3;  // MISS: a message past the batch matches no literal
    if (m < nb) {
      v = j < P ? pre_m[(size_t)(b0 + m) * P + j]
                : suf_m[(size_t)(b0 + m) * S + j - P];
    }
    s_tok[m][j] = v;
  }
  if (threadIdx.x < MB) {
    s_len[threadIdx.x] = threadIdx.x < nb ? mlen[b0 + threadIdx.x] : 0;
  }
  __syncthreads();
  for (int base = 0; base < N; base += blockDim.x) {
    const int n = base + threadIdx.x;
    bool ok[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      ok[m] = n < N && (need >= 0 ? s_len[m] >= need : s_len[m] == pl);
    }
    if (n < N) {
      for (int j0 = 0; j0 < C; j0 += kCellBatch) {
        if (j0 > 0) load_cells(c, pre_t, P, suf_t, S, N, n, j0);
#pragma unroll
        for (int u = 0; u < kCellBatch; ++u) {
          if (j0 + u < C) {
#pragma unroll
            for (int m = 0; m < MB; ++m) {
              ok[m] &= c[u] < 0 || c[u] == s_tok[m][j0 + u];
            }
          }
        }
      }
    }
    ballot_rows<MB>(ok, s_hit, nwords, n);
    load_row(n + blockDim.x);
  }
  __syncthreads();
  or_hit_rows(s_hit, nwords, masks, out, b0, nb, W, s_or);
}

template <int MB>
__global__ void __launch_bounds__(CHANA_THREADS) headers_match_kernel(
    const int* __restrict__ req_t, const int* __restrict__ rcount,
    const unsigned char* __restrict__ is_all,
    const int* __restrict__ masks, const int* __restrict__ pids,
    int* __restrict__ out, int B, int N, int R, int H, int W,
    int vwords) {
  __shared__ int s_or[CHANA_THREADS];
  extern __shared__ unsigned smem[];
  unsigned* s_set = smem;                // [MB][vwords]: message id bitmaps
  unsigned* s_hit = smem + MB * vwords;  // [MB][nwords]
  const int b0 = blockIdx.x * MB;
  const int nb = min(MB, B - b0);
  const int nwords = (N + 31) >> 5;
  // the first rows' cells, in flight while the bitmaps are built
  int need = -1, c[kCellBatch];
  auto load_row = [&](int n) {
    if (n < N) {
      need = is_all[n] ? rcount[n] : -1;
      load_cells(c, req_t, R, req_t, 0, N, n, 0);
    }
  };
  load_row(threadIdx.x);
  s_or[threadIdx.x] = 0;
  for (int i = threadIdx.x; i < MB * vwords; i += blockDim.x) s_set[i] = 0u;
  __syncthreads();
  for (int i = threadIdx.x; i < nb * H; i += blockDim.x) {
    const int id = pids[(size_t)b0 * H + i];
    if (id >= 0 && id < (vwords << 5)) {  // MISS and unknown ids: no row
      atomicOr(&s_set[(i / H) * vwords + (id >> 5)], 1u << (id & 31));
    }
  }
  __syncthreads();
  for (int base = 0; base < N; base += blockDim.x) {
    const int n = base + threadIdx.x;
    bool ok[MB];
    if (n < N) {
      // count the row's required pair ids present in each message; PAD
      // cells (the only negative ones) are not requirements
      int cnt[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m) cnt[m] = 0;
      for (int j0 = 0; j0 < R; j0 += kCellBatch) {
        if (j0 > 0) load_cells(c, req_t, R, req_t, 0, N, n, j0);
#pragma unroll
        for (int u = 0; u < kCellBatch; ++u) {
          if (c[u] >= 0) {
#pragma unroll
            for (int m = 0; m < MB; ++m) {
              cnt[m] += (s_set[m * vwords + (c[u] >> 5)] >> (c[u] & 31)) & 1u;
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        ok[m] = need >= 0 ? cnt[m] == need : cnt[m] > 0;
      }
    } else {
#pragma unroll
      for (int m = 0; m < MB; ++m) ok[m] = false;
    }
    ballot_rows<MB>(ok, s_hit, nwords, n);
    load_row(n + blockDim.x);
  }
  __syncthreads();
  or_hit_rows(s_hit, nwords, masks, out, b0, nb, W, s_or);
}

using TopicFn = void (*)(const int*, const int*, const int*, const int*,
                         const unsigned char*, const int*, const int*,
                         const int*, const int*, int*, int, int, int, int,
                         int);
using HeadersFn = void (*)(const int*, const int*, const unsigned char*,
                           const int*, const int*, int*, int, int, int, int,
                           int, int);

TopicFn topic_fn(int mb) {
  switch (mb) {
    case 1: return topic_match_kernel<1>;
    case 2: return topic_match_kernel<2>;
    case 4: return topic_match_kernel<4>;
    default: return nullptr;
  }
}

HeadersFn headers_fn(int mb) {
  switch (mb) {
    case 1: return headers_match_kernel<1>;
    case 2: return headers_match_kernel<2>;
    case 4: return headers_match_kernel<4>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Each launcher runs on the caller's stream and returns cudaGetLastError()
// (0 = launched). Shapes and the tables' cells are validated by the Python
// wrapper; the checks here refuse what the kernels cannot hold. mb is the
// messages a block (1, 2 or 4): ceil(B / mb) blocks of CHANA_THREADS.

int chana_topic_match(const void* pre_t, const void* suf_t, const void* plen,
                      const void* slen, const void* has_hash,
                      const void* masks, const void* pre_m,
                      const void* suf_m, const void* mlen, void* out, int B,
                      int N, int P, int S, int W, int mb, void* stream) {
  const TopicFn fn = topic_fn(mb);
  if (fn == nullptr || B <= 0 || N <= 0 || N > CHANA_MAX_ROWS || W <= 0 ||
      P < 0 || S < 0 || P > CHANA_MAX_TOKENS || S > CHANA_MAX_TOKENS) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(unsigned) * mb * ((N + 31) / 32);
  fn<<<(B + mb - 1) / mb, CHANA_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)pre_t, (const int*)suf_t, (const int*)plen,
      (const int*)slen, (const unsigned char*)has_hash, (const int*)masks,
      (const int*)pre_m, (const int*)suf_m, (const int*)mlen, (int*)out, B,
      N, P, S, W);
  return (int)cudaGetLastError();
}

// vocab: the table's pair ids are 0 .. vocab - 1 (1 <= vocab <= 65536).
int chana_headers_match(const void* req_t, const void* rcount,
                        const void* is_all, const void* masks,
                        const void* pids, void* out, int B, int N, int R,
                        int H, int W, int vocab, int mb, void* stream) {
  const HeadersFn fn = headers_fn(mb);
  if (fn == nullptr || B <= 0 || N <= 0 || N > CHANA_MAX_ROWS || W <= 0 ||
      R < 0 || H < 0 || vocab <= 0 || vocab > CHANA_MAX_IDS) {
    return (int)cudaErrorInvalidValue;
  }
  const int vwords = (vocab + 31) / 32;
  const size_t smem = sizeof(unsigned) * mb * (vwords + (N + 31) / 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fn<<<(B + mb - 1) / mb, CHANA_THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)req_t, (const int*)rcount, (const unsigned char*)is_all,
      (const int*)masks, (const int*)pids, (int*)out, B, N, R, H, W, vwords);
  return (int)cudaGetLastError();
}

const char* chana_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
