// Batched late-interaction MaxSim rerank scores (Hopper, sm_90a).
//
// Replaces the TPU kernel `maxsim_scores_pallas`
// (triple_hybrid_rag_tpu/ops/pallas/maxsim_kernel.py), and serves the engine's
// rerank stage, where the JAX engine uses the einsum `ops/maxsim.maxsim_scores`.
// For query b and candidate k with parent row p = parent[b, k]:
//
//   sim[t, i] = sum_d bf16(doc[p, t, d]) * bf16(q[b, i, d])   (f32 sums)
//   per_q[i]  = max over unmasked doc tokens t of sim[t, i]
//   score     = sum_i max(per_q[i], 0) * w[b, i] / max(sum_i w[b, i], 1)
//
// and 0 when p < 0 or the parent has no unmasked token. Both operands are
// rounded to bf16 before the product, as the reference does: keeping f32
// queries drifts by ~1e-3, enough to flip candidates at the 0.6 safety gate.
//
// What bounds it on an H100: at the serving shape (B = 128 queries, K = 50
// candidates, 32 doc tokens of width 64, 16 query tokens) the function reads
// 26 MB of gathered bf16 doc tokens and does 0.84 GFLOP: about 8 us of bytes
// at 3.35 TB/s against about 1 us of bf16 products. It is bound by bytes (and,
// at this size, by launch latency).
// Design: one block per (query, candidate). The block gathers its parent's
// token rows itself (no [B, K, Td, D] copy is materialised), keeps the query
// tokens in shared memory, streams the doc tokens in tiles of 32 rows and
// holds a running max per query token in registers, so no [Td, Tq] matrix is
// ever stored. The clamped weighted mean is done in the epilogue.
//
// Interface: plain C, bound with ctypes; launches on the given stream and
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // doc tokens per shared-memory tile

__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const __nv_bfloat16* __restrict__ tokens,  // [p_rows, td, d]
              const uint8_t* __restrict__ tok_mask,      // [p_rows, td]
              const int64_t* __restrict__ parent,        // [b * k]
              const float* __restrict__ q,               // [b, tq, d]
              const float* __restrict__ qw,              // [b, tq]
              float* __restrict__ out,                   // [b * k]
              int p_rows, int td, int d, int tq, int k) {
  extern __shared__ float smem[];
  const int ld = d + 1;           // padded rows: query tokens of one warp hit distinct banks
  float* q_s = smem;              // [tq][ld]
  float* doc_s = smem + tq * ld;  // [kTile][ld]
  __shared__ float part[kThreads];
  __shared__ int tile_live[kTile];

  const int cand = blockIdx.x;
  const int bq = cand / k;
  const int64_t pid = parent[cand];
  if (pid < 0) {  // invalid candidate (block-uniform)
    if (threadIdx.x == 0) out[cand] = 0.f;
    return;
  }
  const int64_t p = pid < p_rows ? pid : (int64_t)p_rows - 1;

  for (int e = threadIdx.x; e < tq * d; e += kThreads) {
    const int i = e / d, c = e % d;
    q_s[i * ld + c] = __bfloat162float(__float2bfloat16_rn(q[(size_t)bq * tq * d + e]));
  }

  // thread (i, grp): query token i, doc tokens grp, grp + groups, ... of each tile
  const int groups = kThreads / tq;  // tq <= kThreads is checked by the wrapper
  const int i = threadIdx.x % tq;
  const int grp = threadIdx.x / tq;
  const bool active = grp < groups;
  float run = -INFINITY;
  int any_doc = 0;

  const __nv_bfloat16* doc = tokens + (size_t)p * td * d;
  const uint8_t* dmask = tok_mask + (size_t)p * td;
  for (int t0 = 0; t0 < td; t0 += kTile) {
    const int nt = min(kTile, td - t0);
    __syncthreads();  // previous tile fully consumed
    for (int e = threadIdx.x; e < nt * d; e += kThreads) {
      const int t = e / d, c = e % d;
      doc_s[t * ld + c] = __bfloat162float(doc[(size_t)(t0 + t) * d + c]);
    }
    for (int t = threadIdx.x; t < nt; t += kThreads) tile_live[t] = dmask[t0 + t] != 0;
    __syncthreads();
    if (active) {
      for (int t = grp; t < nt; t += groups) {
        if (!tile_live[t]) continue;
        any_doc = 1;
        const float* qr = q_s + i * ld;
        const float* dr = doc_s + t * ld;
        float acc = 0.f;
        for (int c = 0; c < d; ++c) acc = fmaf(qr[c], dr[c], acc);
        run = fmaxf(run, acc);
      }
    }
  }
  const int has_doc = __syncthreads_or(any_doc);
  part[threadIdx.x] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    float num = 0.f, den = 0.f;
    for (int qi = 0; qi < tq; ++qi) {
      float m = -INFINITY;
      for (int g2 = 0; g2 < groups; ++g2) m = fmaxf(m, part[g2 * tq + qi]);
      const float w = qw[(size_t)bq * tq + qi];
      num += fmaxf(m, 0.f) * w;
      den += w;
    }
    out[cand] = has_doc ? num / fmaxf(den, 1.f) : 0.f;
  }
}

}  // namespace

extern "C" {

int maxsim_scores_bf16(const void* tokens, const void* tok_mask, const void* parent,
                       const void* q, const void* qw, void* out, int p_rows, int td, int d,
                       int tq, int n_cand, int k, void* stream) {
  const size_t smem = (size_t)(tq + kTile) * (d + 1) * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  maxsim_kernel<<<n_cand, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tokens), static_cast<const uint8_t*>(tok_mask),
      static_cast<const int64_t*>(parent), static_cast<const float*>(q),
      static_cast<const float*>(qw), static_cast<float*>(out), p_rows, td, d, tq, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
