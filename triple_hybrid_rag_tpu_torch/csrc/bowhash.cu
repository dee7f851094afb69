// BowHash query encode on the card (Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package embeds a query batch on the host, where
// each token's direction is numpy's `default_rng(seed).standard_normal(dim)` with
// `seed` the first 8 bytes (little-endian) of the SHA-256 of the token's key, one
// generator per token (models/embedder.py `BowHashEmbedder`). Those draws were
// most of the batched path's host prep. This source draws the same streams, bit
// for bit, on the card, and pools them into the engine's query wire format:
//
//   bowhash_draw_kernel: one thread per stream (a distinct token of a kind):
//     SeedSequence(seed) -> the 4 x u64 `generate_state` -> `pcg64_set_seed` ->
//     `dim` draws of numpy's 64-bit ziggurat `random_standard_normal` (PCG64
//     XSL-RR output; the idx == 0 tail through log1p, the wedge through exp), each
//     rounded to f32 as `.astype(np.float32)` does; the stream's f32 row and its
//     norm (the sum of squares in f64, rounded once).
//   bowhash_pool_kernel: one block per query: the `tok` directions (row / norm in
//   f32) summed in token order in f32 (`acc += v`, as the host does), normalized,
//   cut to `out_dim` and normalized again (`truncate_matryoshka`), to f16; the
//   first T `mtok` directions (row / norm) to f16, zero past the text's tokens.
//
// What bounds it: latency. A stream is sequential (a rejection consumes a
// variable number of 64-bit words), and the work is small: about 900 streams of
// 2,048 draws and as many of 128 a batch of 128 queries, each draw a 128-bit LCG
// step and a table lookup. So every stream gets its own thread and the streams
// are spread one warp a block over the SMs; the ziggurat tables (6 KB) sit in each
// block's shared memory. The rows are written stream-major, so the pool reads
// them coalesced. Every rounding step that decides a comparison uses the
// round-to-nearest intrinsics, so no multiply-add is contracted where numpy's
// x86-64 build rounds twice. exp and log1p are CUDA's (within 1 ulp of glibc's):
// they can move a draw only where a comparison falls within an ulp of its bound.
//
// Interface: plain C, bound with ctypes. Each function launches on the given
// stream and returns a cudaError_t (cudaGetLastError() after the launches) as an int.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ziggurat_tables.cuh"

namespace {

constexpr int kDrawThreads = 32;   // one warp a block: the streams spread over the SMs
constexpr int kPoolThreads = 256;
constexpr int kTable = 256;

// numpy/random/bit_generator.pyx: SeedSequence's hash constants
constexpr uint32_t kInitA = 0x43b0d7e5u;
constexpr uint32_t kMultA = 0x931e8875u;
constexpr uint32_t kInitB = 0x8b51f9ddu;
constexpr uint32_t kMultB = 0x58f38dedu;
constexpr uint32_t kMixMultL = 0xca01f9ddu;
constexpr uint32_t kMixMultR = 0x4973f715u;
// numpy/random/src/pcg64: PCG_DEFAULT_MULTIPLIER_128
constexpr uint64_t kMulHi = 2549297995355413924ULL;
constexpr uint64_t kMulLo = 4865540595714422341ULL;
// numpy/random/src/distributions/ziggurat_constants.h
constexpr double kZigR = 3.6541528853610087963519472518;
constexpr double kZigInvR = 0.27366123732975827203338247596;

struct Pcg64 {
  uint64_t hi, lo, inc_hi, inc_lo;
};

__device__ __forceinline__ uint32_t hashmix(uint32_t value, uint32_t& hash_const) {
  value ^= hash_const;
  hash_const *= kMultA;
  value *= hash_const;
  value ^= value >> 16;
  return value;
}

__device__ __forceinline__ uint32_t mix(uint32_t x, uint32_t y) {
  uint32_t r = kMixMultL * x - kMixMultR * y;
  r ^= r >> 16;
  return r;
}

// state = state * MULT + inc, mod 2^128
__device__ __forceinline__ void pcg_step(Pcg64& g) {
  const uint64_t lo = g.lo * kMulLo;
  uint64_t hi = __umul64hi(g.lo, kMulLo) + g.lo * kMulHi + g.hi * kMulLo;
  const uint64_t sum = lo + g.inc_lo;
  hi += g.inc_hi + (sum < lo ? 1ULL : 0ULL);
  g.lo = sum;
  g.hi = hi;
}

// default_rng(seed)'s PCG64 state: SeedSequence over the seed's 32-bit words,
// least significant first. A seed below 2^32 has one word; the pool of four is
// then run out with hashmix(0), which is what the second word (0) gives too.
__device__ void pcg64_seed(uint64_t seed, Pcg64& g) {
  uint32_t hash_const = kInitA;
  uint32_t pool[4];
  pool[0] = hashmix(static_cast<uint32_t>(seed), hash_const);
  pool[1] = hashmix(static_cast<uint32_t>(seed >> 32), hash_const);
  pool[2] = hashmix(0u, hash_const);
  pool[3] = hashmix(0u, hash_const);
#pragma unroll
  for (int src = 0; src < 4; ++src) {
#pragma unroll
    for (int dst = 0; dst < 4; ++dst) {
      if (src != dst) pool[dst] = mix(pool[dst], hashmix(pool[src], hash_const));
    }
  }
  // generate_state(4, np.uint64): eight words, paired little-endian
  uint32_t words[8];
  uint32_t hb = kInitB;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t v = pool[i & 3];
    v ^= hb;
    hb *= kMultB;
    v *= hb;
    v ^= v >> 16;
    words[i] = v;
  }
  uint64_t s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = words[2 * i] | (static_cast<uint64_t>(words[2 * i + 1]) << 32);
  // pcg64_set_seed(state = s[0]:s[1], inc = s[2]:s[3]) (high word first)
  g.inc_hi = (s[2] << 1) | (s[3] >> 63);
  g.inc_lo = (s[3] << 1) | 1ULL;
  g.hi = 0;
  g.lo = 0;
  pcg_step(g);
  const uint64_t lo = g.lo + s[1];
  g.hi += s[0] + (lo < g.lo ? 1ULL : 0ULL);
  g.lo = lo;
  pcg_step(g);
}

// pcg64_next64: step, then XSL-RR of the new state
__device__ __forceinline__ uint64_t next_u64(Pcg64& g) {
  pcg_step(g);
  const uint64_t x = g.hi ^ g.lo;
  const unsigned rot = static_cast<unsigned>(g.hi >> 58);
  return (x >> rot) | (x << ((64u - rot) & 63u));
}

__device__ __forceinline__ double next_double(Pcg64& g) {
  return __dmul_rn(static_cast<double>(next_u64(g) >> 11), 1.0 / 9007199254740992.0);
}

// numpy's random_standard_normal (distributions.c), step for step
__device__ double standard_normal(Pcg64& g, const uint64_t* ki, const double* wi,
                                  const double* fi) {
  for (;;) {
    uint64_t r = next_u64(g);
    const int idx = static_cast<int>(r & 0xff);
    r >>= 8;
    const int sign = static_cast<int>(r & 0x1);
    const uint64_t rabs = (r >> 1) & 0x000fffffffffffffULL;
    double x = __dmul_rn(static_cast<double>(rabs), wi[idx]);
    if (sign) x = -x;
    if (rabs < ki[idx]) return x;  // 99.3 % of draws
    if (idx == 0) {
      for (;;) {
        const double xx = __dmul_rn(-kZigInvR, log1p(-next_double(g)));
        const double yy = -log1p(-next_double(g));
        if (__dadd_rn(yy, yy) > __dmul_rn(xx, xx)) {
          return ((rabs >> 8) & 0x1) ? -__dadd_rn(kZigR, xx) : __dadd_rn(kZigR, xx);
        }
      }
    } else {
      const double f = __dadd_rn(__dmul_rn(__dsub_rn(fi[idx - 1], fi[idx]), next_double(g)), fi[idx]);
      if (f < exp(__dmul_rn(__dmul_rn(-0.5, x), x))) return x;
    }
  }
}

// Streams [0, n_a) draw dim_a values into raw_a (stream-major), streams
// [n_a, n_a + n_b) dim_b values into raw_b; norms[s] is stream s's f32 norm.
__global__ void __launch_bounds__(kDrawThreads)
bowhash_draw_kernel(const uint64_t* __restrict__ seeds, int n_a, int dim_a, int n_b, int dim_b,
                    float* __restrict__ raw_a, float* __restrict__ raw_b,
                    float* __restrict__ norms) {
  __shared__ uint64_t ki[kTable];
  __shared__ double wi[kTable];
  __shared__ double fi[kTable];
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) {
    ki[i] = kZigKi[i];
    wi[i] = __longlong_as_double(static_cast<long long>(kZigWiBits[i]));
    fi[i] = __longlong_as_double(static_cast<long long>(kZigFiBits[i]));
  }
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_a + n_b) return;
  const bool first = s < n_a;
  const int dim = first ? dim_a : dim_b;
  float* row = first ? raw_a + static_cast<size_t>(s) * dim_a
                     : raw_b + static_cast<size_t>(s - n_a) * dim_b;
  Pcg64 g;
  pcg64_seed(seeds[s], g);
  double sumsq = 0.0;
  int j = 0;
  if ((dim & 3) == 0) {  // rows of whole float4s (the wrapper aligns both buffers)
    for (; j < dim; j += 4) {
      float4 v;
      v.x = __double2float_rn(standard_normal(g, ki, wi, fi));
      v.y = __double2float_rn(standard_normal(g, ki, wi, fi));
      v.z = __double2float_rn(standard_normal(g, ki, wi, fi));
      v.w = __double2float_rn(standard_normal(g, ki, wi, fi));
      sumsq += static_cast<double>(v.x) * v.x + static_cast<double>(v.y) * v.y +
               static_cast<double>(v.z) * v.z + static_cast<double>(v.w) * v.w;
      *reinterpret_cast<float4*>(row + j) = v;
    }
  }
  for (; j < dim; ++j) {
    const float v = __double2float_rn(standard_normal(g, ki, wi, fi));
    sumsq += static_cast<double>(v) * v;
    row[j] = v;
  }
  norms[s] = __double2float_rn(sqrt(sumsq));
}

// The block's sum of `v` over its threads, in f64, returned to every thread.
__device__ double block_sum(double v, double* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch is free again (an earlier call's readers are done)
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double total = 0.0;
  for (int w = 0; w < kPoolThreads / 32; ++w) total += scratch[w];
  return total;
}

// One block per query b. tok_idx[b, :L]: the query's dense streams in token order
// (-1 past its tokens); mtok_idx[b, :T]: its MaxSim streams (-1 past them).
__global__ void __launch_bounds__(kPoolThreads)
bowhash_pool_kernel(const int32_t* __restrict__ tok_idx, int L, const float* __restrict__ raw_a,
                    const float* __restrict__ norms_a, int dim_a, int out_dim,
                    const int32_t* __restrict__ mtok_idx, int T, const float* __restrict__ raw_b,
                    const float* __restrict__ norms_b, int dim_b, __half* __restrict__ q_vec,
                    __half* __restrict__ q_tok) {
  extern __shared__ float acc[];  // [dim_a]
  __shared__ double scratch[kPoolThreads / 32];
  const int b = blockIdx.x;
  const int32_t* toks = tok_idx + static_cast<size_t>(b) * L;
  double part = 0.0;
  for (int d = threadIdx.x; d < dim_a; d += kPoolThreads) {
    float v = 0.0f;
    for (int t = 0; t < L; ++t) {
      const int s = toks[t];
      if (s < 0) break;
      v = __fadd_rn(v, __fdiv_rn(raw_a[static_cast<size_t>(s) * dim_a + d], norms_a[s]));
    }
    acc[d] = v;
    part += static_cast<double>(v) * v;
  }
  const float n = __double2float_rn(sqrt(block_sum(part, scratch)));
  part = 0.0;
  for (int d = threadIdx.x; d < out_dim; d += kPoolThreads) {
    const float v = n > 0.0f ? __fdiv_rn(acc[d], n) : acc[d];
    acc[d] = v;
    part += static_cast<double>(v) * v;
  }
  const float n2 = fmaxf(__double2float_rn(sqrt(block_sum(part, scratch))), 1e-12f);
  for (int d = threadIdx.x; d < out_dim; d += kPoolThreads) {
    q_vec[static_cast<size_t>(b) * out_dim + d] = __float2half_rn(__fdiv_rn(acc[d], n2));
  }
  const int32_t* mtoks = mtok_idx + static_cast<size_t>(b) * T;
  __half* out = q_tok + static_cast<size_t>(b) * T * dim_b;
  for (int e = threadIdx.x; e < T * dim_b; e += kPoolThreads) {
    const int j = e / dim_b, d = e - j * dim_b;
    const int s = mtoks[j];
    out[e] = s < 0 ? __float2half_rn(0.0f)
                   : __float2half_rn(__fdiv_rn(raw_b[static_cast<size_t>(s) * dim_b + d], norms_b[s]));
  }
}

inline int draw_blocks(int n) { return (n + kDrawThreads - 1) / kDrawThreads; }

}  // namespace

extern "C" {

// A batch's encode: seeds u64[n_tok + n_m] (the dense streams, then the MaxSim
// streams), tok_idx i32[b, l], mtok_idx i32[b, t]; scratch raw_tok f32[n_tok,
// dim_tok], raw_m f32[n_m, dim_m], norms f32[n_tok + n_m]; out q_vec f16[b,
// out_dim], q_tok f16[b, t, dim_m]. The pool needs dim_tok * 4 bytes of shared
// memory (the wrapper keeps it, with the pool's 64 bytes of static scratch, within
// the default 48 KB).
int bowhash_encode(const void* seeds, int n_tok, int dim_tok, int n_m, int dim_m,
                    const void* tok_idx, int b, int l, const void* mtok_idx, int t, int out_dim,
                    void* raw_tok, void* raw_m, void* norms, void* q_vec, void* q_tok,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* nrm = static_cast<float*>(norms);
  if (n_tok + n_m > 0) {
    bowhash_draw_kernel<<<draw_blocks(n_tok + n_m), kDrawThreads, 0, st>>>(
        static_cast<const uint64_t*>(seeds), n_tok, dim_tok, n_m, dim_m,
        static_cast<float*>(raw_tok), static_cast<float*>(raw_m), nrm);
  }
  if (b > 0) {
    bowhash_pool_kernel<<<b, kPoolThreads, dim_tok * sizeof(float), st>>>(
        static_cast<const int32_t*>(tok_idx), l, static_cast<const float*>(raw_tok), nrm, dim_tok,
        out_dim, static_cast<const int32_t*>(mtok_idx), t, static_cast<const float*>(raw_m),
        nrm + n_tok, dim_m, static_cast<__half*>(q_vec), static_cast<__half*>(q_tok));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
