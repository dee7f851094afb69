// Doc-major BM25 membership scan over a term table (Hopper, sm_90a).
//
// Replaces the TPU kernel `score_termtable_pallas`
// (triple_hybrid_rag_tpu/ops/pallas/lexical_kernel.py). For a table of unique
// terms per document ids i32[N, L] (DOC_PAD = -2 in empty slots) with
// precomputed BM25 contributions w f32|bf16[N, L], and queries i32[B, Q]
// (QUERY_PAD = -1 in empty slots, real terms >= 0):
//
//     out[b, n] = sum_l  any_q(ids[n, l] == query[b, q]) ? float(w[n, l]) : 0
//
// The TPU kernel scores one query per pass over the table. Here a block takes
// 128 queries and 8 rows, so the table is read from device memory once per 128
// queries.
//
// What bounds it on an H100 at N = 1,000,448, L = 128, Q = 16, B = 128: by the
// roofline, bytes: the 1.02 GB table read once and 0.51 GB of scores written
// take 0.46 ms at 3.35 TB/s, and compares have no tensor-core rate to set
// against that. This simple kernel is far above that bound: it does one integer
// compare per (row, live slot, query, query term), on the ordinary ALUs.
// Design: the block stages its 8 rows (ids, and weights widened to f32) in
// shared memory; lane = query, each thread keeps its query's terms in
// registers and walks the 8 x L slots. Every lane of a warp reads the same
// slot, so the reads are broadcasts and the two data-dependent shortcuts are
// uniform branches: an empty slot (DOC_PAD) is skipped, and the compare loop
// stops after the last live query term of the warp. A thread sums one row's
// matches in slot order and writes 8 adjacent f32 of its query's score row (one
// 32-byte sector).
//
// Interface: plain C, bound with ctypes. The function launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDocPad = -2;
constexpr int kQueryPad = -1;
constexpr int kRows = 8;       // table rows per block
constexpr int kQueries = 128;  // queries per block = threads per block
constexpr int kMaxTerms = 32;  // query slots kept in registers

template <typename W>
__device__ __forceinline__ float widen(W w);
template <>
__device__ __forceinline__ float widen<float>(float w) { return w; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

template <typename W>
__global__ void __launch_bounds__(kQueries)
termtable_kernel(const int32_t* __restrict__ ids,    // [n, l]
                 const W* __restrict__ weights,      // [n, l]
                 const int32_t* __restrict__ query,  // [b, q]
                 float* __restrict__ out,            // [b, n]
                 int n, int l, int b, int q) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_ids = reinterpret_cast<int32_t*>(smem);        // [kRows * l]
  float* s_w = reinterpret_cast<float*>(smem) + kRows * l;  // [kRows * l]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int qi = blockIdx.y * kQueries + tid;

  // the block's rows are one contiguous piece of the table
  const size_t base = (size_t)row0 * l;
  const int live = min(kRows, n - row0) * l;
  for (int e = tid; e < kRows * l; e += kQueries) {
    s_ids[e] = e < live ? ids[base + e] : kDocPad;
    s_w[e] = e < live ? widen<W>(weights[base + e]) : 0.f;
  }

  // this thread's query: terms in registers, the count up to its last live
  // term, and whether it has an empty slot (a table id of -1 matches those)
  int terms[kMaxTerms];
  int n_terms = 0;
  bool has_pad = false;
#pragma unroll
  for (int j = 0; j < kMaxTerms; ++j) {
    int t = (qi < b && j < q) ? query[(size_t)qi * q + j] : kQueryPad;
    terms[j] = t;
    if (t != kQueryPad) n_terms = j + 1;
    if (j < q && t == kQueryPad) has_pad = true;
  }
  // the warp's loop bound, so that the compare loop branches uniformly
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    n_terms = max(n_terms, __shfl_xor_sync(0xffffffffu, n_terms, off));
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int32_t* rid = s_ids + r * l;
    const float* rw = s_w + r * l;
    float a = 0.f;
    for (int s = 0; s < l; ++s) {
      const int id = rid[s];
      if (id == kDocPad) continue;
      bool match = false;
      if (id == kQueryPad) {
        match = has_pad;
      } else {
#pragma unroll
        for (int j = 0; j < kMaxTerms; j += 4) {
          if (j >= n_terms) break;
          match |= (id == terms[j]) | (id == terms[j + 1]) | (id == terms[j + 2]) |
                   (id == terms[j + 3]);
        }
      }
      a += match ? rw[s] : 0.f;
    }
    acc[r] = a;
  }
  if (qi < b) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (row0 + r < n) out[(size_t)qi * n + row0 + r] = acc[r];
  }
}

template <typename W>
int launch(const void* ids, const void* weights, const void* query, void* out, int n, int l,
           int b, int q, void* stream) {
  const size_t smem = (size_t)kRows * l * (sizeof(int32_t) + sizeof(float));
  if (smem > 48 * 1024 || q > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((n + kRows - 1) / kRows, (b + kQueries - 1) / kQueries);
  termtable_kernel<W><<<grid, kQueries, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const W*>(weights),
      static_cast<const int32_t*>(query), static_cast<float*>(out), n, l, b, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int termtable_scores_f32(const void* ids, const void* weights, const void* query, void* out,
                         int n, int l, int b, int q, void* stream) {
  return launch<float>(ids, weights, query, out, n, l, b, q, stream);
}

int termtable_scores_bf16(const void* ids, const void* weights, const void* query, void* out,
                          int n, int l, int b, int q, void* stream) {
  return launch<__nv_bfloat16>(ids, weights, query, out, n, l, b, q, stream);
}

}  // extern "C"
