// Fused dense scoring + bucket maxima for the exact dense top-k (Hopper, sm_90a).
//
// Replaces the TPU kernel `bucket_maxima_pallas`
// (triple_hybrid_rag_tpu/ops/pallas/fused_topk.py): the float bodies
// `_kernel_float*`, the int8 bodies `_kernel_int8*` and the packed-int4 bodies
// `_kernel_int4*`. For corpus rows e[N, D] and queries q[B, D] it computes the
// score s[b, n] of every pair, sets invalid rows (and, when scoped, rows outside
// the query's collection: cid -1 = unscoped, -2 = match nothing) to -inf, and
// writes only the max over each group of 16 adjacent rows: out f32[B, ceil(N/16)].
// The f32[B, N] score matrix never reaches device memory. The caller
// (ops/fused_topk.py) selects the top-k buckets and rescores their members.
//
// Scores per row type:
//   bf16 / f32  s = q . e, f32 sums
//   int8        s = (float(acc) * scale[n]) * q_scale[b], acc the exact int32 dot
//               of the int8 row and the int8-quantized query; the two multiplies
//               stay separate and in this order, so s equals the plain version's
//               bit for bit (no --use_fast_math)
//   int4        rows are packed bytes u8[N, D/2]: column j in the low nibble,
//               column j + D/2 in the high nibble, codes in [-7, 7]. The nibbles
//               are widened in registers to int8 values 16 * code (low:
//               (p << 4) & 0xF0, high: p & 0xF0, per byte of a 32-bit word; the
//               sign bit of the nibble lands on the sign bit of the byte), two s8
//               MMAs per packed k-step take the low half against q[:, c : c+32]
//               and the high half against q[:, D/2+c : D/2+c+32], and the exact
//               int32 sum is shifted right by 4 before the int8 dequantization.
//
// What bounds it on an H100 at the serving shape (N = 1,000,448, D = 1024,
// B = 128): the bytes of the rows. bf16 rows are 2.05 GB (0.61 ms at 3.35 TB/s)
// against 268 GFLOP (0.27 ms at 989 TFLOP/s); int8 rows 1.02 GB (0.32 ms)
// against 0.13 ms at the int8 tensor-core rate; int4 rows 0.51 GB (0.16 ms)
// against the same 0.13 ms, nearly balanced. Design: each row is read from
// device memory once, by one block that owns a tile of 128 rows and 128 queries
// (csrc/tile_common.cuh: cp.async in two stages, mma.sync, f32 or s32 sums in
// registers). The 16-row bucket is one m16 tile of a warp, so the epilogue
// reduces it with three shuffles and no shared-memory round trip.
//
// Interface: plain C, bound with ctypes. Every function launches on the given
// stream and returns cudaGetLastError() as an int.

#include "tile_common.cuh"

namespace {

using namespace tile;

constexpr int kBucket = 16;

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

struct ScoreFloat {
  __device__ __forceinline__ float operator()(float acc, int, int) const { return acc; }
};

// (float(acc >> shift) * scale[r]) * q_scale[q]: shift 0 for int8, 4 for int4.
struct ScoreInt {
  const float* scale;    // [n]
  const float* q_scale;  // [b]
  int n, b, shift;
  __device__ __forceinline__ float operator()(int acc, int r, int q) const {
    if (r >= n || q >= b) return 0.f;
    float s = static_cast<float>(acc >> shift) * scale[r];
    return s * q_scale[q];
  }
};

struct Masks {
  const uint8_t* valid;  // [n]
  const int32_t* coll;   // [n] or null
  const int32_t* cid;    // [b] or null
};

// An m16 tile is one bucket. Lane (g, t) holds rows g and g+8 for queries 2t
// and 2t+1 of each n8 tile; the max over g takes three shuffles.
template <typename Acc, typename Score>
__device__ __forceinline__ void bucket_epilogue(const Acc (&acc)[2][8][4], const Score& score,
                                                const Lane& ln, const Masks& m, int row0, int q0,
                                                int n, int b, int nb, float* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rbase = row0 + ln.warp_m * 32 + i * 16;
    const int r_lo = rbase + ln.g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qa = q0 + ln.warp_n * 64 + j * 8 + 2 * ln.t;
      const int qb = qa + 1;
      float ma = fmaxf(
          masked(score(acc[i][j][0], r_lo, qa), r_lo, qa, n, b, m.valid, m.coll, m.cid),
          masked(score(acc[i][j][2], r_hi, qa), r_hi, qa, n, b, m.valid, m.coll, m.cid));
      float mb = fmaxf(
          masked(score(acc[i][j][1], r_lo, qb), r_lo, qb, n, b, m.valid, m.coll, m.cid),
          masked(score(acc[i][j][3], r_hi, qb), r_hi, qb, n, b, m.valid, m.coll, m.cid));
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      }
      const int bucket = rbase / kBucket;
      if (ln.g == 0 && bucket < nb) {
        if (qa < b) out[(size_t)qa * nb + bucket] = ma;
        if (qb < b) out[(size_t)qb * nb + bucket] = mb;
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 and int8 rows
template <typename Mma, typename Score>
__global__ void __launch_bounds__(kThreads, 2)
bucket_max_kernel(const uint8_t* __restrict__ emb,  // [n, row_bytes]
                  const uint8_t* __restrict__ qv,   // [b, row_bytes]
                  Score score, Masks m, float* __restrict__ out,  // [b, nb]
                  int n, int row_bytes, int b, int nb) {
  __shared__ __align__(16) Smem sm;
  const Lane ln;
  const int row0 = blockIdx.x * BM;
  const int q0 = blockIdx.y * BN;
  typename Mma::acc_t acc[2][8][4];
  mainloop<Mma>(emb, qv, n, row_bytes, b, row0, q0, sm, ln, acc);
  bucket_epilogue(acc, score, ln, m, row0, q0, n, b, nb, out);
}

// ---------------------------------------------------------------- packed int4 rows
constexpr int PK = 32;        // packed bytes of a row per stage: 32 low + 32 high columns
constexpr int PLD = PK + 16;  // padded smem row (48 bytes): conflict-free fragment loads

struct SmemInt4 {
  uint8_t a[2][BM][PLD];    // packed row stages
  uint8_t qlo[2][BN][PLD];  // query columns [c, c + 32)
  uint8_t qhi[2][BN][PLD];  // query columns [D/2 + c, D/2 + c + 32)
};

__global__ void __launch_bounds__(kThreads, 2)
bucket_max_int4_kernel(const uint8_t* __restrict__ emb,  // [n, d2] packed
                       const uint8_t* __restrict__ qv,   // [b, 2 * d2] int8
                       ScoreInt score, Masks m, float* __restrict__ out, int n, int d2, int b,
                       int nb) {
  __shared__ __align__(16) SmemInt4 sm;
  const Lane ln;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int q0 = blockIdx.y * BN;

  // each stage: 128 rows x 2 chunks of 16 bytes for each of the three arrays
  auto load_stage = [&](int stage, int k0) {
    const int r = tid >> 1;
    const int ch = (tid & 1) * 16;
    const int col = k0 + ch;
    const bool in_k = col < d2;
    const int gr = row0 + r;
    const bool pa = in_k && gr < n;
    cp_async16(&sm.a[stage][r][ch], pa ? emb + (size_t)gr * d2 + col : emb, pa);
    const int gq = q0 + r;
    const bool pq = in_k && gq < b;
    const uint8_t* qrow = qv + (size_t)(pq ? gq : 0) * (2 * (size_t)d2);
    cp_async16(&sm.qlo[stage][r][ch], pq ? qrow + col : qv, pq);
    cp_async16(&sm.qhi[stage][r][ch], pq ? qrow + d2 + col : qv, pq);
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int kt_n = (d2 + PK - 1) / PK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    if (kt + 1 < kt_n) {
      load_stage((kt + 1) & 1, (kt + 1) * PK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
    uint32_t lo[2][4], hi[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ln.warp_m * 32 + i * 16 + ln.g;
      uint32_t x[4];
      x[0] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r][4 * ln.t]);
      x[1] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r + 8][4 * ln.t]);
      x[2] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r][4 * ln.t + 16]);
      x[3] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r + 8][4 * ln.t + 16]);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        lo[i][v] = (x[v] << 4) & 0xF0F0F0F0u;  // 16 * low-nibble code, per byte
        hi[i][v] = x[v] & 0xF0F0F0F0u;         // 16 * high-nibble code, per byte
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qn = ln.warp_n * 64 + j * 8 + ln.g;
      uint32_t l0 = *reinterpret_cast<const uint32_t*>(&sm.qlo[st][qn][4 * ln.t]);
      uint32_t l1 = *reinterpret_cast<const uint32_t*>(&sm.qlo[st][qn][4 * ln.t + 16]);
      uint32_t h0 = *reinterpret_cast<const uint32_t*>(&sm.qhi[st][qn][4 * ln.t]);
      uint32_t h1 = *reinterpret_cast<const uint32_t*>(&sm.qhi[st][qn][4 * ln.t + 16]);
      MmaS8::mma(acc[0][j], lo[0], l0, l1);
      MmaS8::mma(acc[1][j], lo[1], l0, l1);
      MmaS8::mma(acc[0][j], hi[0], h0, h1);
      MmaS8::mma(acc[1][j], hi[1], h0, h1);
    }
    __syncthreads();
  }
  bucket_epilogue(acc, score, ln, m, row0, q0, n, b, nb, out);
}

// ---------------------------------------------------------------- f32 rows
__global__ void __launch_bounds__(kThreadsF32)
bucket_max_f32_kernel(const float* __restrict__ emb, const float* __restrict__ qv, Masks m,
                      float* __restrict__ out, int n, int d, int b, int nb) {
  __shared__ SmemF32 sm;
  __shared__ float S[FM][FN + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // queries tx*4 .. tx*4+3
  const int ty = tid >> 4;  // rows ty*4 .. ty*4+3
  const int row0 = blockIdx.x * FM;
  const int q0 = blockIdx.y * FN;

  float acc[4][4];
  mainloop_f32(emb, qv, n, d, b, row0, q0, sm, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = ty * 4 + i, q = tx * 4 + j;
      S[r][q] = masked(acc[i][j], row0 + r, q0 + q, n, b, m.valid, m.coll, m.cid);
    }
  __syncthreads();
  // 4 buckets x 64 queries: one output per thread
  const int bk = tid >> 6;
  const int q = tid & 63;
  float mx = -INFINITY;
#pragma unroll
  for (int r = 0; r < kBucket; ++r) mx = fmaxf(mx, S[bk * kBucket + r][q]);
  const int bucket = row0 / kBucket + bk;
  if (bucket < nb && q0 + q < b) out[(size_t)(q0 + q) * nb + bucket] = mx;
}

Masks masks(const void* valid, const void* coll, const void* cid) {
  return Masks{static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(coll),
               static_cast<const int32_t*>(cid)};
}

}  // namespace

extern "C" {

int fused_bucket_maxima_bf16(const void* emb, const void* q, const void* valid,
                             const void* coll, const void* cid, void* out, int n, int d,
                             int b, void* stream) {
  const int nb = (n + kBucket - 1) / kBucket;
  dim3 grid((n + BM - 1) / BM, (b + BN - 1) / BN);
  bucket_max_kernel<MmaBf16, ScoreFloat><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(emb), static_cast<const uint8_t*>(q), ScoreFloat{},
      masks(valid, coll, cid), static_cast<float*>(out), n, d * 2, b, nb);
  return static_cast<int>(cudaGetLastError());
}

// int8 rows [n, d] with row scales, int8 queries [b, d] with query scales
int fused_bucket_maxima_int8(const void* emb, const void* scales, const void* q,
                             const void* q_scale, const void* valid, const void* coll,
                             const void* cid, void* out, int n, int d, int b, void* stream) {
  const int nb = (n + kBucket - 1) / kBucket;
  dim3 grid((n + BM - 1) / BM, (b + BN - 1) / BN);
  ScoreInt score{static_cast<const float*>(scales), static_cast<const float*>(q_scale), n, b, 0};
  bucket_max_kernel<MmaS8, ScoreInt><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(emb), static_cast<const uint8_t*>(q), score,
      masks(valid, coll, cid), static_cast<float*>(out), n, d, b, nb);
  return static_cast<int>(cudaGetLastError());
}

// packed int4 rows [n, d / 2] with row scales, int8 queries [b, d] with query scales
int fused_bucket_maxima_int4(const void* emb, const void* scales, const void* q,
                             const void* q_scale, const void* valid, const void* coll,
                             const void* cid, void* out, int n, int d, int b, void* stream) {
  const int nb = (n + kBucket - 1) / kBucket;
  dim3 grid((n + BM - 1) / BM, (b + BN - 1) / BN);
  ScoreInt score{static_cast<const float*>(scales), static_cast<const float*>(q_scale), n, b, 4};
  bucket_max_int4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(emb), static_cast<const uint8_t*>(q), score,
      masks(valid, coll, cid), static_cast<float*>(out), n, d / 2, b, nb);
  return static_cast<int>(cudaGetLastError());
}

int fused_bucket_maxima_f32(const void* emb, const void* q, const void* valid,
                            const void* coll, const void* cid, void* out, int n, int d, int b,
                            void* stream) {
  const int nb = (n + kBucket - 1) / kBucket;
  dim3 grid((n + FM - 1) / FM, (b + FN - 1) / FN);
  bucket_max_f32_kernel<<<grid, kThreadsF32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const float*>(q), masks(valid, coll, cid),
      static_cast<float*>(out), n, d, b, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
