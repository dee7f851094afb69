// Fused dense scoring + bucket maxima for the exact dense top-k (Hopper, sm_90a).
//
// Replaces the TPU kernel `bucket_maxima_pallas`
// (triple_hybrid_rag_tpu/ops/pallas/fused_topk.py, float variants `_kernel_float`
// and `_kernel_float_scoped`). For corpus rows e[N, D] and queries q[B, D] it
// computes s[b, n] = q[b] . e[n] with f32 accumulation, sets invalid rows (and,
// when scoped, rows outside the query's collection: cid -1 = unscoped, -2 =
// match nothing) to -inf, and writes only the max over each group of 16
// adjacent rows: out f32[B, ceil(N/16)]. The f32[B, N] score matrix never
// reaches device memory. The caller (ops/fused_topk.py) selects the top-k
// buckets and rescores their members exactly.
//
// What bounds it on an H100: at the serving shape (N = 1,000,448, D = 1024,
// B = 128, bf16 rows) the work is 2*B*N*D = 268 GFLOP over 2.05 GB of rows.
// The rows take 0.61 ms at 3.35 TB/s; the products take 0.27 ms at the bf16
// tensor-core rate (989 TFLOP/s). The kernel is bound by the bytes of the rows.
// Design: each row is read from device memory once, by one block that owns a
// tile of 128 rows and 128 queries. Tiles of 32 columns stream through shared
// memory with cp.async in two stages, and mma.sync m16n8k16 (bf16 operands,
// f32 sums) does the products, so the SMs spend little time per byte. The
// 16-row bucket is one m16 tile of a warp, so the epilogue reduces it with
// three shuffles and no shared-memory round trip.
//
// The float32 variant keeps full f32 products (no TF32) with plain FMAs in a
// 64 x 64 tile; it is not on the serving path.
//
// Interface: plain C, bound with ctypes. Every function launches on the given
// stream and returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBucket = 16;

// ---------------------------------------------------------------- bf16 rows
constexpr int BM = 128;           // corpus rows per block
constexpr int BN = 128;           // queries per block
constexpr int BK = 32;            // columns per pipeline stage
constexpr int LDS = BK + 8;       // padded smem row (80 bytes): conflict-free fragment loads
constexpr int kThreads = 256;     // 8 warps: 4 along rows x 2 along queries

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Score of (row r, query q) after the validity and collection masks.
__device__ __forceinline__ float masked(float s, int r, int q, int n, int b,
                                       const uint8_t* __restrict__ valid,
                                       const int32_t* __restrict__ coll,
                                       const int32_t* __restrict__ cid) {
  if (r >= n || !valid[r]) return -INFINITY;
  if (coll != nullptr && q < b) {
    int c = cid[q];
    if (c != -1 && coll[r] != c) return -INFINITY;
  }
  return s;
}

__global__ void __launch_bounds__(kThreads, 2)
bucket_max_bf16_kernel(const __nv_bfloat16* __restrict__ emb,  // [n, d]
                       const __nv_bfloat16* __restrict__ qv,   // [b, d]
                       const uint8_t* __restrict__ valid,      // [n]
                       const int32_t* __restrict__ coll,       // [n] or null
                       const int32_t* __restrict__ cid,        // [b] or null
                       float* __restrict__ out,                // [b, nb]
                       int n, int d, int b, int nb) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Qs[2][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 3;   // 32 rows each
  const int warp_n = warp >> 2;  // 64 queries each
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int q0 = blockIdx.y * BN;

  // each stage: 128 rows x 4 chunks of 16 bytes, for rows and for queries
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * kThreads;  // 0..511
      int r = c >> 2;
      int col = k0 + (c & 3) * 8;
      bool in_k = col < d;
      int gr = row0 + r;
      bool pa = in_k && gr < n;
      cp_async16(&As[stage][r][(c & 3) * 8], pa ? emb + (size_t)gr * d + col : emb, pa);
      int gq = q0 + r;
      bool pq = in_k && gq < b;
      cp_async16(&Qs[stage][r][(c & 3) * 8], pq ? qv + (size_t)gq * d + col : qv, pq);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  const int kt_n = (d + BK - 1) / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    if (kt + 1 < kt_n) {
      load_stage((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int r = warp_m * 32 + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&As[st][r][kk + 2 * t]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][kk + 2 * t]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&As[st][r][kk + 2 * t + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&As[st][r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int qn = warp_n * 64 + j * 8 + g;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Qs[st][qn][kk + 2 * t]);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Qs[st][qn][kk + 2 * t + 8]);
        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);
      }
    }
    __syncthreads();
  }

  // epilogue: an m16 tile is one bucket. Lane (g, t) holds rows g and g+8 for
  // queries 2t and 2t+1 of each n8 tile; the max over g takes three shuffles.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rbase = row0 + warp_m * 32 + i * 16;
    const int r_lo = rbase + g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qa = q0 + warp_n * 64 + j * 8 + 2 * t;
      const int qb = qa + 1;
      float ma = fmaxf(masked(acc[i][j][0], r_lo, qa, n, b, valid, coll, cid),
                       masked(acc[i][j][2], r_hi, qa, n, b, valid, coll, cid));
      float mb = fmaxf(masked(acc[i][j][1], r_lo, qb, n, b, valid, coll, cid),
                       masked(acc[i][j][3], r_hi, qb, n, b, valid, coll, cid));
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      }
      const int bucket = rbase / kBucket;
      if (g == 0 && bucket < nb) {
        if (qa < b) out[(size_t)qa * nb + bucket] = ma;
        if (qb < b) out[(size_t)qb * nb + bucket] = mb;
      }
    }
  }
}

// ---------------------------------------------------------------- f32 rows
constexpr int FM = 64;   // rows per block
constexpr int FN = 64;   // queries per block
constexpr int FK = 16;   // columns per step

__global__ void __launch_bounds__(256)
bucket_max_f32_kernel(const float* __restrict__ emb, const float* __restrict__ qv,
                      const uint8_t* __restrict__ valid, const int32_t* __restrict__ coll,
                      const int32_t* __restrict__ cid, float* __restrict__ out, int n, int d,
                      int b, int nb) {
  __shared__ float As[FK][FM + 4];
  __shared__ float Qs[FK][FN + 4];
  __shared__ float S[FM][FN + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // queries tx*4 .. tx*4+3
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int row0 = blockIdx.x * FM;
  const int q0 = blockIdx.y * FN;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += FK) {
    for (int e = tid; e < FM * FK; e += 256) {
      int r = e / FK, k = e % FK;
      int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < n && gk < d) ? emb[(size_t)gr * d + gk] : 0.f;
      int gq = q0 + r;
      Qs[k][r] = (gq < b && gk < d) ? qv[(size_t)gq * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float av[4], qw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) qw[j] = Qs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], qw[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = ty * 4 + i, q = tx * 4 + j;
      S[r][q] = masked(acc[i][j], row0 + r, q0 + q, n, b, valid, coll, cid);
    }
  __syncthreads();
  // 4 buckets x 64 queries: one output per thread
  const int bk = tid >> 6;
  const int q = tid & 63;
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < kBucket; ++r) m = fmaxf(m, S[bk * kBucket + r][q]);
  const int bucket = row0 / kBucket + bk;
  if (bucket < nb && q0 + q < b) out[(size_t)(q0 + q) * nb + bucket] = m;
}

}  // namespace

extern "C" {

int fused_bucket_maxima_bf16(const void* emb, const void* q, const void* valid,
                             const void* coll, const void* cid, void* out, int n, int d,
                             int b, void* stream) {
  const int nb = (n + kBucket - 1) / kBucket;
  dim3 grid((n + BM - 1) / BM, (b + BN - 1) / BN);
  bucket_max_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(emb), static_cast<const __nv_bfloat16*>(q),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(coll),
      static_cast<const int32_t*>(cid), static_cast<float*>(out), n, d, b, nb);
  return static_cast<int>(cudaGetLastError());
}

int fused_bucket_maxima_f32(const void* emb, const void* q, const void* valid,
                            const void* coll, const void* cid, void* out, int n, int d, int b,
                            void* stream) {
  const int nb = (n + kBucket - 1) / kBucket;
  dim3 grid((n + FM - 1) / FM, (b + FN - 1) / FN);
  bucket_max_f32_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const float*>(q),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(coll),
      static_cast<const int32_t*>(cid), static_cast<float*>(out), n, d, b, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
