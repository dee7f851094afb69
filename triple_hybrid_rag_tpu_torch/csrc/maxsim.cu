// Batched late-interaction MaxSim rerank scores (Hopper, sm_90a).
//
// Replaces the TPU kernel `maxsim_scores_pallas` and its body `_kernel`
// (triple_hybrid_rag_tpu/ops/pallas/maxsim_kernel.py), and serves the engine's
// rerank stage, where the JAX engine uses the einsum `ops/maxsim.maxsim_scores`.
// For query b and candidate k with parent row p = parent[b, k] (a row past the
// store is clamped to its last row):
//
//   sim[t, i] = sum_d doc[p, t, d] * bf16(q[b, i, d])   (f32 sums)
//   per_q[i]  = max over unmasked doc tokens t of sim[t, i]
//   score     = sum_i max(per_q[i], 0) * w[b, i] / max(sum_i w[b, i], 1)
//
// and 0 when p < 0 or the parent has no unmasked token. doc is the bf16 token,
// or, for an int8 store, bf16(bf16(x) * bf16(1/127)) as the reference's
// `dequantize_tokens` computes it: the product of an int8 value and the bf16
// scale is exact in f32, so one round to nearest-even in registers gives the
// reference's bits. Both operands are bf16 and the sums f32, as in the
// reference (keeping f32 queries drifts by ~1e-3, enough to flip candidates at
// the 0.6 safety gate).
//
// What bounds it on an H100: the gathered token bytes. At B = 128 queries x
// K = 50 candidates (45 valid each) the smoke run's shape (Td = 32 doc tokens of
// width D = 64, Tq = 16) reads 23.6 MB of bf16 tokens (7.0 us at 3.35 TB/s) for
// 0.38 GFLOP; the default shape (Td = 64, D = 128, Tq = 32) reads 94 MB (28 us)
// for 3.0 GFLOP: 3 us on the bf16 tensor cores, 45 us on the f32 ALU. An int8
// store halves the bytes and adds a widening of every element to bf16. So the
// products go to the tensor cores, and the rest of the design is about keeping
// the memory busy from the first microsecond to the last.
//
// Three plans, chosen by the launcher from the shape alone:
//
// 1. The staged plan (`maxsim_kernel<T, true>`), for the served shapes: Tq <= 128
//    where one staged query fits shared memory beside a one-warp ring of whole rows.
// - mma.sync.m16n8k16 bf16 -> f32, the query tokens as A (M = Tq: one m16 tile at
//   Tq = 16, two at 32) and the doc tokens as B (N = doc tokens, K = D). A wgmma
//   tile has 64 rows: with the query as M it would be 75 % padding at Tq = 16,
//   and with the doc tokens as M half padding at Td = 32. The products are a
//   tenth of the byte time either way, and mma.sync lets each warp run a
//   pipeline of its own, with no warpgroup-wide waits.
// - One wave of blocks (as many as fit the card), each serving an equal run of
//   the flattened (query, candidate) list, so that every SM gets the same work.
//   A block stages the (at most kMaxBlockQueries) queries its run spans once:
//   bf16, in shared memory, A fragments by ldmatrix; no query byte is read per
//   candidate. Every global load a block needs first (parents, queries,
//   weights) is issued before any of them is used.
// - Each warp owns every W-th candidate of the run and a ring of two stages of
//   its own; a stage is a tile of 32 doc tokens of one candidate. The warp starts
//   the copy of tile j + 1 (of this or of its next candidate) before it
//   multiplies tile j. Invalid candidates are never copied. On the card, deeper
//   rings (3 or 4 stages, also of 16 tokens) and more waves of smaller blocks
//   were slower: more warps on an SM matter more than more tiles in flight per
//   warp.
// - Copies: one TMA box per tile (32 rows of the store seen as a 2-D tensor, the
//   box as wide as the padded shared-memory row, so TMA zero-fills the pad, the
//   k tail and rows past the store), where the row is a multiple of 16 bytes
//   (plain loads for the rest). The tile's mask bytes come by 4-byte cp.async.
//   Both report to the stage's mbarrier (TMA by its byte count, cp.async by
//   cp.async.mbarrier.arrive), the only wait. Tiles copied by per-lane 16-byte
//   cp.async kept the memory less busy than TMA boxes.
// - Shared-memory rows are D rounded up to 32 elements, with a pitch of an odd
//   number of 32-element chunks: the fragment loads (16 bytes a lane for bf16,
//   8 for int8) then hit distinct banks.
// - The k axis is permuted within each 32-element chunk so that a lane's B
//   fragments for two k-steps are 8 consecutive elements of its doc token (one
//   16-byte load for bf16, one 8-byte load for int8); the query is staged with
//   the same permutation, and a dot product does not depend on the order of its
//   terms. The next chunk's elements are loaded while this chunk multiplies.
// - int8 body: the lane widens its 8 bytes to bf16 with the scale in registers
//   (widen4: no I2F) while building the fragments; the tensor work stays bf16.
// - Epilogue without a serial loop: a tile's mask is one 32-bit ballot; masked
//   doc tokens become -inf by an added bias; each lane keeps a running max per
//   query token over the tiles; at a candidate's end the max goes across the
//   quad with two shuffles, and the weighted sum and the weights' sum over Tq
//   across the warp with three each. One store per candidate. has_doc is the OR
//   of the tile masks. No [Td, Tq] matrix is ever stored, so any Td streams (the
//   reference's blockwise requirement).
//
// 2. The wgmma plan (`maxsim_wgmma_kernel<T, N>`), for every other shape whose rows
//    TMA reaches (a multiple of 16 bytes, from a 16-byte aligned store): more than
//    128 query tokens, or a query or row too wide for the staged plan. The score
//    is separable over query tokens (sum_i max(per_q[i], 0) w[i], divided once at
//    the end), so the query tokens are walked in passes of N.
// - The query is rounded to bf16 once per launch by `round_query_kernel` into
//    bf16[B, Tq padded to N, D padded to 64], the scratch the caller allocates.
// - M is 64 doc tokens of one candidate, N = 64, 128 or 256 query tokens (the
//    smallest that holds Tq, else 256 a pass), K = D in stages of 64 elements. A
//    consumer warpgroup keeps its f32 accumulator (m64nN, 128 registers at N =
//    256) across all of D, so a candidate's tokens are read once a pass: once at
//    Tq <= 256.
// - One persistent block per SM: a producer thread and two consumer warpgroups
//    (setmaxnreg 40 / 232). Work item (query, pair of candidates) gives one
//    candidate to each consumer; items go in (query, pair) order, so that the
//    blocks at work share a few queries, warm in L2. A four-stage ring: a stage is
//    the query's [N, 64] tile (one TMA load for both consumers) and each valid
//    candidate's [64, 64] doc tile (a 3-D box over [parent, token, byte]: tokens
//    past Td read as zero, never the next parent's). Invalid candidates are never
//    copied; a consumer without one hands its stages back (Pipeline::skip).
// - bf16 store: both operands from shared memory (128-byte swizzle). int8 store:
//    the doc tile lands as int8 (64-byte rows); each lane loads 16 bytes of each
//    of its two rows and widens them with the scale (widen4) into the A fragments
//    of the stage's four k-steps, wgmma then takes A from registers; the rounding
//    pass permutes the query's elements within each 64-element chunk to match.
// - Epilogue per candidate and 64-token tile: a -inf bias for masked tokens and
//    tokens past Td; the max over a thread's two rows, across the 8 lanes of a
//    column (three half-exchanges), across the four warps through shared memory;
//    a running max over the tiles; then clamp(., 0) x w into the candidate's sums,
//    across passes. One store per candidate.
// - Bound at Tq = 256, D = 1024, B = 128 x K = 50 (45 valid), Td = 64: the bf16
//    tokens 0.76 GB and the f32 query 0.13 GB, 0.27 ms at 3.35 TB/s; 2 x 0.3 M live
//    doc tokens x 256 x 1024 = 0.15 TFLOP, 0.16 ms at the bf16 peak. int8 tokens
//    halve the first term, so the products bound it. Each stage brings 32 KB of
//    query and 2 x 8 KB of doc tokens from L2 for 1,024 cycles of tensor work.
//
// 3. The general plan (`maxsim_kernel<T, false>`), for the rest: rows TMA cannot
//    address (an odd D, int8 rows not of 16-byte multiples), which no engine
//    shape has. No query is staged: a lane builds its A fragments from the f32
//    query in device memory; blocks stride the flattened candidates; a stage holds
//    32 doc tokens x a chunk of the row of at most 384 bytes, and when a row takes
//    several stages a pass covers 32 query tokens (the candidate's tokens stream
//    once per pass). It costs about 18.5 ns x Tq x D / 1000 for 6,400 candidates
//    (PERF.md).
//
// Interface: plain C, bound with ctypes; launches on the given stream and
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "per_device.cuh"
#include "tile_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kTile = 32;            // doc tokens per stage
constexpr int kNT = kTile / 8;       // n8 tiles of a stage
constexpr int kStages = 2;           // a warp's ring: one tile in flight while it multiplies the other
constexpr int kMaskBytes = 128;      // a stage's mask bytes (32 used; keeps stages 128-byte aligned)
constexpr int kMaxQ = 128;           // query tokens of the staged plan; of a pass of the general one
constexpr int kSliceQ = 32;          // query tokens of a pass when a row takes several stages
constexpr int kMaxWarps = 4;         // warps of a block (fewer when shared memory needs it)
constexpr int kMaxBlockQueries = 4;  // queries whose candidates one block may serve
constexpr int kQBatch = 4;           // 8-element query groups a thread loads before it stores
constexpr int kMaxTmaRow = 1024;     // widest padded row one TMA box holds (256 4-byte elements)
constexpr int kMaxChunkRow = 384;    // widest padded row of a general-plan stage

// 4 bytes of which only `src_bytes` are read; the rest of the word is zero-filled
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

// the barrier completes one arrival when this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(hopper::smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(hopper::smem_addr(smem)));
}

// Four int8 tokens -> two packed pairs bf16(bf16(x) * s), exactly: a byte u = x + 128
// placed in the mantissa of 2^23 is the float 2^23 + u, and one FMA with
// cs = -(2^23 + 128) s (exact in f32) gives x s, which f32 holds exactly; the pack
// rounds it to bf16. (No I2F, which runs at a quarter of the FMA rate.)
__device__ __forceinline__ void widen4(uint32_t w, float s, float cs, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)), s, cs);
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]), b = __floats2bfloat162_rn(f[2], f[3]);
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

// A fragments of one k-step for query tokens r and r + 8 straight from the f32 query
// in device memory (the general plan): a[0], a[2] = token r, elements col .. col + 3
// (k slots 2 c4, 2 c4 + 1 and 2 c4 + 8, 2 c4 + 9 of the step, as the staged query's
// permutation places them); a[1], a[3] = token r + 8. Tokens >= tq and elements >= d
// read as 0. `vec`: rows of 16-byte multiples from a 16-byte aligned query.
__device__ __forceinline__ void a_from_query(uint32_t (&a)[4], const float* __restrict__ qg, int r,
                                             int col, int tq, int d, bool vec) {
  float x[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    const float* src = qg + static_cast<size_t>(row) * d + col;
    if (row < tq && vec && col + 4 <= d) {
      const float4 f = *reinterpret_cast<const float4*>(src);
      x[h][0] = f.x, x[h][1] = f.y, x[h][2] = f.z, x[h][3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[h][j] = row < tq && col + j < d ? src[j] : 0.f;
    }
  }
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(x[0][0], x[0][1]), p2 = __floats2bfloat162_rn(x[0][2], x[0][3]);
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(x[1][0], x[1][1]), p3 = __floats2bfloat162_rn(x[1][2], x[1][3]);
  a[0] = *reinterpret_cast<const uint32_t*>(&p0);
  a[1] = *reinterpret_cast<const uint32_t*>(&p1);
  a[2] = *reinterpret_cast<const uint32_t*>(&p2);
  a[3] = *reinterpret_cast<const uint32_t*>(&p3);
}

struct Shape {
  int p_rows, td, d, tq, b, k;
  int chunk;    // candidates (flattened b * k + j) a block serves, from blockIdx.x * chunk
  int queries;  // query slots staged in shared memory; 0: the general plan (none staged)
  int rs;       // bytes between doc-token rows in shared memory
  int tma;      // 1: one TMA box per stage; 0: plain loads (rows TMA cannot address)
  int dc;       // elements of a row a stage holds (a multiple of 32): all of it, or a chunk
  int pass;     // query tokens of a pass over a candidate's doc tokens
};

// kStaged: the staged plan (Shape::queries > 0), else the general one. The two are
// instantiations of this one kernel, so that the general plan's registers (A
// fragments built from device memory, sums kept across a row's stages) do not cut
// the staged plan's resident warps.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kMaxWarps * 32)
maxsim_kernel(const __grid_constant__ CUtensorMap map_tok,  // [p_rows * td, d] (TMA path)
              const T* __restrict__ tokens,         // [p_rows, td, d] bf16 or int8
              const uint8_t* __restrict__ tok_mask,  // [p_rows, td], 4-byte aligned
              const int64_t* __restrict__ parent,    // [b, k]
              const float* __restrict__ q,           // [b, tq, d]
              const float* __restrict__ qw,          // [b, tq]
              float* __restrict__ out,               // [b, k]
              const Shape sh) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int E = sizeof(T);
  extern __shared__ __align__(128) uint8_t smem[];
  const int td = sh.td, d = sh.d, tq = sh.tq, k = sh.k, rs = sh.rs;
  const int kc = (d + 31) >> 5, d32 = kc << 5;
  const int qs = d32 * 2 + 16;  // query row: 16 bytes past a multiple of 64, ldmatrix without conflicts
  const int mtiles = (tq + 15) >> 4;
  const bool tma = sh.tma != 0;
  const int q_bytes = kStaged ? (mtiles * 16 * qs + 127) & ~127 : 0;  // one staged query
  float* w_s = reinterpret_cast<float*>(smem);           // [queries][kMaxQ] weights
  uint8_t* q_s = smem + sh.queries * kMaxQ * 4;          // [queries] staged queries
  const int stage_bytes = kTile * rs + kMaskBytes;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* ring = q_s + sh.queries * q_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + warps * kStages * stage_bytes) + warp * kStages;
  ring += warp * kStages * stage_bytes;

  // this block's candidates, flattened (b * k + j), and the queries they belong to
  const int64_t total = static_cast<int64_t>(sh.b) * k;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * sh.chunk;
  const int64_t hi = min(total, lo + sh.chunk);
  const int b0 = kStaged ? static_cast<int>(lo / k) : 0;  // the first query staged
  const int nq_staged = kStaged ? static_cast<int>((hi - 1) / k) - b0 + 1 : 0;

  // The warp's j-th candidate is cand0 + j * stride. The staged plan serves the block's
  // run; the general plan strides the grid (block i takes candidates i, i + grid, ...),
  // so that the blocks resident at once read the f32 rows of a few queries.
  // ---- every global load the block needs first, so that their latencies overlap:
  // the parents of this warp's candidates (the j-th in lane j), the first kQBatch
  // 8-element groups of the queries a thread stages, the queries' weights ----
  const int64_t stride = kStaged ? warps : static_cast<int64_t>(warps) * gridDim.x;
  const int64_t cand0 = kStaged ? lo + warp : static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;
  const int64_t end = kStaged ? hi : total;
  const int n_mine = end > cand0 ? static_cast<int>((end - cand0 + stride - 1) / stride) : 0;
  const int64_t pid = lane < n_mine ? parent[cand0 + static_cast<int64_t>(lane) * stride] : -1;
  const float* qb = q + static_cast<size_t>(b0) * tq * d;
  const int groups_row = kc * 4, rows16 = mtiles * 16, groups = nq_staged * rows16 * groups_row;
  float v[kQBatch][8];
  auto load_query = [&](int g0) {
#pragma unroll
    for (int u = 0; u < kQBatch; ++u) {
      const int grp = g0 + u * blockDim.x, r = grp / groups_row, c0 = (grp - r * groups_row) * 8;
      const int qi = r / rows16, i = r - qi * rows16;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[u][j] = (grp < groups && i < tq && c0 + j < d)
                      ? qb[(static_cast<size_t>(qi) * tq + i) * d + c0 + j] : 0.f;
    }
  };
  // bf16, k-permuted, zero-padded to 16 rows x d32: elements c0..c0+7 of a group are
  // slots (2c, 2c+1) and (2c+8, 2c+9) of the chunk's k-steps 0 and 1
  auto store_query = [&](int g0) {
#pragma unroll
    for (int u = 0; u < kQBatch; ++u) {
      const int grp = g0 + u * blockDim.x, r = grp / groups_row, c0 = (grp - r * groups_row) * 8;
      if (grp >= groups) break;
      const int qi = r / rows16, i = r - qi * rows16;
      uint32_t* row = reinterpret_cast<uint32_t*>(q_s + qi * q_bytes + i * qs + (c0 & ~31) * 2);
      const int c = (c0 & 31) >> 3;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const __nv_bfloat162 x = __floats2bfloat162_rn(v[u][4 * s], v[u][4 * s + 1]);
        const __nv_bfloat162 y = __floats2bfloat162_rn(v[u][4 * s + 2], v[u][4 * s + 3]);
        row[8 * s + c] = *reinterpret_cast<const uint32_t*>(&x);
        row[8 * s + 4 + c] = *reinterpret_cast<const uint32_t*>(&y);
      }
    }
  };
  load_query(threadIdx.x);
  const float* wb = qw + static_cast<size_t>(b0) * tq;
  const float w0 = threadIdx.x < nq_staged * tq ? wb[threadIdx.x] : 0.f;

  if (lane < n_mine && pid < 0) out[cand0 + static_cast<int64_t>(lane) * stride] = 0.f;
  const unsigned valid = __ballot_sync(~0u, lane < n_mine && pid >= 0);
  const int64_t prow = pid < sh.p_rows ? pid : static_cast<int64_t>(sh.p_rows) - 1;
  const int row_bytes = d * E;
  const int n_tiles = (td + kTile - 1) / kTile;
  const int cpc = kStaged ? kc : sh.dc >> 5;                      // 32-element chunks a stage holds
  const int n_chunks = kStaged ? 1 : (kc + cpc - 1) / cpc;        // stages a doc-token tile takes
  const int n_pass = kStaged ? 1 : (tq + sh.pass - 1) / sh.pass;  // passes over a candidate's tokens

  if (lane == 0)
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(&bars[s], tma ? 33 : 32);
  hopper::mbar_fence_init();
  __syncwarp();

  // ---- the producer: a warp copies its own stages, S - 1 ahead of their use: per
  // candidate, per pass, per tile of doc tokens, per chunk of the row ----
  const size_t mask_total = static_cast<size_t>(sh.p_rows) * td;
  int pi = valid ? __ffs(valid) - 1 : -1, pp = 0, pt = 0, pc = 0;  // next: candidate pi, pass pp, tile pt, chunk pc
  auto issue = [&](int stage) {
    if (pi < 0) return;
    uint8_t* dst = ring + stage * stage_bytes;
    const int64_t p = __shfl_sync(~0u, prow, pi);
    const int t0 = pt * kTile, rows = min(kTile, td - t0);
    const int64_t row0 = p * td + t0;  // the tile's first token row of the store
    const int col0 = kStaged ? 0 : pc * sh.dc * E;  // the chunk's first byte of a row
    if (tma) {  // one box of 32 padded rows, zero past the row and past the store
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&bars[stage], kTile * rs);
        hopper::tma_load_2d(dst, &map_tok, col0 / 4, static_cast<int>(row0), &bars[stage]);
      }
    } else {  // plain loads, zero past the row; the __syncwarp before the stage is read orders them
      const int cw = min(cpc, kc - pc * cpc) * 32 * E;  // bytes of a row the stage's products read
      const uint8_t* src = reinterpret_cast<const uint8_t*>(tokens) + static_cast<size_t>(row0) * row_bytes;
      for (int i = lane; i < rows * cw; i += 32) {
        const int r = i / cw, c = i - r * cw;
        dst[r * rs + c] = col0 + c < row_bytes ? src[static_cast<size_t>(r) * row_bytes + col0 + c] : 0;
      }
    }
    // the mask bytes, as the aligned words that cover them (the consumer skips row0 & 3)
    const size_t a = (static_cast<size_t>(row0) & ~size_t(3)) + 4 * lane;
    if (lane < 9 && a < static_cast<size_t>(row0) + rows) {
      const size_t left = mask_total - a;
      cp_async4_zfill(dst + kTile * rs + 4 * lane, tok_mask + a, left < 4 ? static_cast<int>(left) : 4);
    }
    cp_async_arrive(&bars[stage]);  // each lane's copies: 32 arrivals, + 1 with expect_tx
    if (++pc == n_chunks) {
      pc = 0;
      if (++pt == n_tiles) {
        pt = 0;
        if (++pp == n_pass) {
          pp = 0;
          const unsigned rest = valid & ~((2u << pi) - 1u);
          pi = rest ? __ffs(rest) - 1 : -1;
        }
      }
    }
  };
  issue(0);

  // ---- the query and its weights into shared memory, while the tiles are in flight ----
  store_query(threadIdx.x);
  for (int g0 = threadIdx.x + kQBatch * blockDim.x; g0 < groups; g0 += kQBatch * blockDim.x) {
    load_query(g0);
    store_query(g0);
  }
  for (int i = threadIdx.x; i < nq_staged * tq; i += blockDim.x)
    w_s[(i / tq) * kMaxQ + i % tq] = i == threadIdx.x ? w0 : wb[i];
  __syncthreads();  // the only block-wide barrier
  if (valid == 0) return;

  // lane (g, c4): doc tokens 8n + g of each n8 tile (B), query tokens g, g + 8 of
  // each m16 tile against doc tokens 8n + 2 c4 and 8n + 2 c4 + 1 (C)
  const int g = lane >> 2, c4 = lane & 3;
  const int b_off = g * rs + 8 * E * c4;
  const bool q_vec = (d & 3) == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const float scale = __bfloat162float(__float2bfloat16_rn(1.f / 127.f));  // bf16(1/127)
  const float scale_off = -8388736.f * scale;  // -(2^23 + 128) bf16(1/127), exact
  int stage = 0, next_stage = 1;
  uint32_t parity = 0;
  for (unsigned todo = valid; todo; todo &= todo - 1) {
    const int ci = __ffs(todo) - 1;
    const int64_t p = __shfl_sync(~0u, prow, ci);
    const int64_t cand = cand0 + static_cast<int64_t>(ci) * stride;
    const int qi = static_cast<int>(cand / k) - b0;
    const uint8_t* qc = q_s + qi * q_bytes;                       // staged: the candidate's query
    const float* qg = qb + static_cast<size_t>(qi) * tq * d;      // general: the same in device memory
    const float* wc = kStaged ? w_s + qi * kMaxQ : wb + static_cast<size_t>(qi) * tq;
    float num = 0.f, den = 0.f;
    unsigned any = 0;
    for (int pass = 0; pass < n_pass; ++pass) {
      const int t_lo = kStaged ? 0 : pass * sh.pass;                          // its first query token
      const int mt = kStaged ? mtiles : (min(sh.pass, tq - t_lo) + 15) >> 4;  // its m16 tiles
      float run[4][2][2];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int m = 0; m < 2; ++m) run[a][m][0] = run[a][m][1] = -INFINITY;
      // the sums of a 32-token slice of the pass against the tile: a row taking several
      // stages (then a pass is one slice) adds every stage into them
      float acc[2][kNT][4];
      for (int tt = 0; tt < n_tiles; ++tt) {
        for (int ck = 0; ck < n_chunks; ++ck) {
          hopper::mbar_wait(&bars[stage], parity);
          __syncwarp();  // every lane is done with the stage the next copy overwrites
          issue(next_stage);
          next_stage ^= 1;
          const uint8_t* st = ring + stage * stage_bytes;
          stage ^= 1;
          parity ^= stage == 0;
          const int t0 = tt * kTile, rows = min(kTile, td - t0);
          const int moff = static_cast<int>((static_cast<size_t>(p) * td + t0) & 3);
          const unsigned live = __ballot_sync(~0u, lane < rows && st[kTile * rs + moff + lane] != 0);
          any |= live;
          if (live == 0) continue;  // the same for every chunk of the tile
          float bias[kNT][2];  // 0 for a live doc token, -inf for a masked one
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) bias[n][j] = (live >> (8 * n + 2 * c4 + j)) & 1u ? 0.f : -INFINITY;
          const int kn = kStaged ? kc : min(cpc, kc - ck * cpc);  // 32-element chunks of this stage
          const int col_ck = kStaged ? 0 : ck * sh.dc;           // their first element of the row

#pragma unroll
          for (int mc = 0; mc < 4; ++mc) {  // 32 query tokens at a time
            if (2 * mc >= mt) break;
            const bool two = 2 * mc + 1 < mt;
            if (ck == 0) {
#pragma unroll
              for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int n = 0; n < kNT; ++n)
#pragma unroll
                  for (int v = 0; v < 4; ++v) acc[m][n][v] = 0.f;
            }
            // the lane's 8 elements of each n8 tile for k chunk kk, loaded one chunk ahead
            using Raw = typename std::conditional<kInt8, uint2, uint4>::type;
            Raw raw[kNT];
#pragma unroll
            for (int n = 0; n < kNT; ++n) raw[n] = *reinterpret_cast<const Raw*>(st + b_off + n * 8 * rs);
            for (int kk = 0; kk < kn; ++kk) {
              uint32_t bf[kNT][2][2];  // [n8 tile][k-step][register]
#pragma unroll
              for (int n = 0; n < kNT; ++n) {
                if constexpr (kInt8) {
                  widen4(raw[n].x, scale, scale_off, bf[n][0][0], bf[n][0][1]);
                  widen4(raw[n].y, scale, scale_off, bf[n][1][0], bf[n][1][1]);
                } else {
                  bf[n][0][0] = raw[n].x;
                  bf[n][0][1] = raw[n].y;
                  bf[n][1][0] = raw[n].z;
                  bf[n][1][1] = raw[n].w;
                }
              }
              if (kk + 1 < kn) {
#pragma unroll
                for (int n = 0; n < kNT; ++n)
                  raw[n] = *reinterpret_cast<const Raw*>(st + b_off + n * 8 * rs + (kk + 1) * 32 * E);
              }
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                const uint8_t* qa = qc + (mc * 32 + (lane & 15)) * qs + (kk * 32 + s * 16 + (lane >> 4) * 8) * 2;
                const int r = t_lo + mc * 32 + g, col = col_ck + kk * 32 + 8 * c4 + 4 * s;
                uint32_t a[4];
                if constexpr (kStaged)
                  ldmatrix_x4(a, qa);
                else
                  a_from_query(a, qg, r, col, tq, d, q_vec);
#pragma unroll
                for (int n = 0; n < kNT; ++n) tile::mma_bf16(acc[0][n], a, bf[n][s][0], bf[n][s][1]);
                if (two) {
                  if constexpr (kStaged)
                    ldmatrix_x4(a, qa + 16 * qs);
                  else
                    a_from_query(a, qg, r + 16, col, tq, d, q_vec);
#pragma unroll
                  for (int n = 0; n < kNT; ++n) tile::mma_bf16(acc[1][n], a, bf[n][s][0], bf[n][s][1]);
                }
              }
            }
            if (ck == n_chunks - 1) {
#pragma unroll
              for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int n = 0; n < kNT; ++n)
#pragma unroll
                  for (int v = 0; v < 4; ++v)
                    run[mc][m][v >> 1] = fmaxf(run[mc][m][v >> 1], acc[m][n][v] + bias[n][v & 1]);
            }
          }
        }
      }

#pragma unroll
      for (int mc = 0; mc < 4; ++mc)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (2 * mc + m >= mt) continue;
            float x = run[mc][m][h];
            x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
            x = fmaxf(x, __shfl_xor_sync(~0u, x, 2));
            const int i = t_lo + mc * 32 + m * 16 + g + 8 * h;
            if (i < tq) {
              num += fmaxf(x, 0.f) * wc[i];
              den += wc[i];
            }
          }
    }
    // the four lanes of a quad hold the same sums: add across the eight quads
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      num += __shfl_xor_sync(~0u, num, o);
      den += __shfl_xor_sync(~0u, den, o);
    }
    if (lane == 0) out[cand] = any ? num / fmaxf(den, 1.f) : 0.f;
  }
}

// ------------------------------------------------------------------ the wgmma plan

constexpr int kWgDocRows = 64;      // doc tokens of a consumer's tile: the M of wgmma
constexpr int kWgKElems = 64;       // elements of D a stage holds (128 bytes of the bf16 query)
constexpr int kWgStages = 4;
constexpr int kWgThreads = 384;     // a producer warpgroup and two consumer warpgroups
constexpr int kWgConsumerWarps = 8;
constexpr int kWgSlot = kWgDocRows * hopper::kStageRowBytes;  // a consumer's doc tile in a stage

// Query tokens a pass covers (the N of wgmma): 64, 128, else 256 (then passes of 256).
inline int wgmma_tile_n(int tq) { return tq <= 64 ? 64 : tq <= 128 ? 128 : 256; }

#define MAXSIM_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define MAXSIM_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define MAXSIM_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63," \
  " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79," \
  " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95," \
  " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111," \
  " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

#define MAXSIM_F8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define MAXSIM_F32(d, i) MAXSIM_F8(d, i), MAXSIM_F8(d, i + 8), MAXSIM_F8(d, i + 16), MAXSIM_F8(d, i + 24)
#define MAXSIM_F64(d, i) MAXSIM_F32(d, i), MAXSIM_F32(d, i + 32)
#define MAXSIM_F128(d) MAXSIM_F64(d, 0), MAXSIM_F64(d, 64)

// d[64 x N] (+)= a[64 x 16] . b[N x 16]^T, bf16 operands, f32 sums; `accumulate` 0
// overwrites d. ss: both operands from shared memory (K-major, 128-byte swizzle); rs:
// a from registers in the fragment layout of mma.m16n8k16 (a[0], a[1] = k 2 (t%4)
// and the next of rows g and g + 8, a[2], a[3] = the same 8 further on; warp w of the
// warpgroup owns rows 16 w ..), read while the wgmma is in flight. d as in
// hopper::WgmmaBf16N256, with N / 8 column groups.
template <int N>
struct WgmmaBf16;

#define MAXSIM_WGMMA(N, R, FLIST, DLIST, A, B, P, RA0, RA1, RA2, RA3, RB, RP)                    \
  template <>                                                                                   \
  struct WgmmaBf16<N> {                                                                         \
    static constexpr int kAcc = R;                                                              \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t da, uint64_t db, int acc) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"                              \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " DLIST            \
                   ", %" A ", %" B ", p, 1, 1, 0, 0;\n}\n"                                       \
                   : FLIST                                                                      \
                   : "l"(da), "l"(db), "r"(acc));                                               \
    }                                                                                           \
    static __device__ __forceinline__ void rs(float (&d)[R], const uint32_t (&a)[4], uint64_t db, \
                                              int acc) {                                        \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" RP ", 0;\n"                             \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " DLIST            \
                   ", {%" RA0 ", %" RA1 ", %" RA2 ", %" RA3 "}, %" RB ", p, 1, 1, 0;\n}\n"       \
                   : FLIST                                                                      \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));            \
    }                                                                                           \
  };

MAXSIM_WGMMA(64, 32, MAXSIM_F32(d, 0), MAXSIM_D32, "32", "33", "34", "32", "33", "34", "35", "36", "37")
MAXSIM_WGMMA(128, 64, MAXSIM_F64(d, 0), MAXSIM_D64, "64", "65", "66", "64", "65", "66", "67", "68", "69")
MAXSIM_WGMMA(256, 128, MAXSIM_F128(d), MAXSIM_D128, "128", "129", "130", "128", "129", "130", "131",
             "132", "133")

#undef MAXSIM_WGMMA
#undef MAXSIM_F128
#undef MAXSIM_F64
#undef MAXSIM_F32
#undef MAXSIM_F8
#undef MAXSIM_D32
#undef MAXSIM_D64
#undef MAXSIM_D128

// Shared memory of a block: a stage holds the two consumers' doc tiles (64 rows x 128
// bytes each, 128-byte swizzle; an int8 tile is 64 rows x 64 bytes, unswizzled, at the
// start of its slot) and the query tile both share (kN rows x 128 bytes, 128-byte
// swizzle). Then each consumer's column maxima of its warps, and its partial sums.
template <int kN>
struct WgSmem {
  hopper::Pipeline<kWgStages, 2 * kWgDocRows, kN, kWgConsumerWarps> pipe;
  alignas(16) float red[2][2][4][kN];  // [consumer][epilogue parity][warp][query token of the pass]
  alignas(16) float fin[2][2][4][2];   // [consumer][candidate parity][warp][numerator, weights]
};

struct WgShape {
  int p_rows, td, d, tq, b, k;
  int tq_pad;  // rows of a query in the rounded buffer: tq rounded up to the pass
  int n_k;     // stages of a doc-token tile: D in steps of 64 elements
  int n_dt;    // 64-token tiles of a parent
  int n_pass;  // passes over the query tokens
};

// The query rounded to bf16 once per launch, as the reference rounds it before its
// Pallas call: qr[b, i, e] = bf16(q[b, i, src(e)]) for i < tq and src(e) < d, else 0,
// over [b, tq_pad, d_pad] (d_pad: d rounded up to 64). For the int8 body the elements
// of each 64-element chunk are permuted so that a lane's A fragments of the chunk's
// four k-steps are 16 consecutive bytes of its doc-token row: slot 16 s + o of the
// chunk (k-step s) holds element 16 ((o & 7) >> 1) + 4 s + (o & 1) + 2 (o >> 3), the
// element that the lane owning the slot's fragment register widens from its word s.
template <bool kPermute>
__global__ void __launch_bounds__(256)
round_query_kernel(const float* __restrict__ q, __nv_bfloat16* __restrict__ qr, int tq, int d,
                   int tq_pad, int d_pad, int64_t groups) {
  const int row_groups = d_pad / 8;
  for (int64_t gi = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; gi < groups;
       gi += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = gi / row_groups;
    const int e0 = static_cast<int>(gi - row * row_groups) * 8;
    const int qb = static_cast<int>(row / tq_pad), i = static_cast<int>(row - static_cast<int64_t>(qb) * tq_pad);
    const float* src = q + (static_cast<int64_t>(qb) * tq + i) * d;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int s = e0 + j;
      if constexpr (kPermute) {
        const int o = s & 15, st = (s & 63) >> 4;
        s = (s & ~63) + 16 * ((o & 7) >> 1) + 4 * st + (o & 1) + 2 * (o >> 3);
      }
      v[j] = __float2bfloat16_rn(i < tq && s < d ? src[s] : 0.f);
    }
    *reinterpret_cast<uint4*>(qr + row * d_pad + e0) = *reinterpret_cast<const uint4*>(v);
  }
}

// One persistent block per SM. Work item (query b, pair j) is candidates 2 j and
// 2 j + 1 of query b, one to each consumer warpgroup; items go in (query, pair) order,
// block i taking items i, i + grid, ..., so that the blocks at work share a few queries,
// warm in L2. For each item with a valid candidate the producer thread streams, per
// pass, per 64-token tile and per 64 elements of D, one stage: the query tile (TMA,
// once for both consumers) and each valid candidate's doc tile (TMA, 3-D over
// [parent, token, byte]: rows past Td read as zero, never the next parent's). A
// consumer keeps its f32 accumulator (64 doc tokens x kN query tokens) over all of D,
// so each doc token is read once a pass; a consumer whose candidate is invalid hands
// the item's stages back unread (Pipeline::skip).
template <typename T, int kN>
__global__ void __launch_bounds__(kWgThreads, 1)
maxsim_wgmma_kernel(const __grid_constant__ CUtensorMap map_doc,  // [p_rows, td, d * E] bytes
                    const __grid_constant__ CUtensorMap map_q,    // [b * tq_pad, d_pad] bf16
                    const uint8_t* __restrict__ tok_mask,          // [p_rows, td]
                    const int64_t* __restrict__ parent,            // [b, k]
                    const float* __restrict__ qw,                  // [b, tq]
                    float* __restrict__ out,                       // [b, k]
                    const WgShape sh) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr uint32_t kDocBytes = kWgDocRows * kWgKElems * sizeof(T);  // a doc tile's stage
  constexpr uint32_t kQBytes = kN * hopper::kStageRowBytes;
  using Mma = WgmmaBf16<kN>;
  extern __shared__ uint8_t smem_raw[];
  WgSmem<kN>& sm = *reinterpret_cast<WgSmem<kN>*>(
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) sm.pipe.init();
  __syncthreads();

  const int pairs = (sh.k + 1) / 2;
  const int n_items = sh.b * pairs;
  const int n_stages = sh.n_pass * sh.n_dt * sh.n_k;  // of an item with a valid candidate
  // the parent of candidate 2 j + c of item (b, j), -1 when invalid or past k
  auto parent_of = [&](int item, int c) -> int64_t {
    if (item >= n_items) return -1;
    const int qb = item / pairs, j = 2 * (item - qb * pairs) + c;
    return j < sh.k ? parent[static_cast<int64_t>(qb) * sh.k + j] : -1;
  };
  // the warpgroup's index, broadcast so that the compiler sees the roles' control
  // flow as uniform across a warp (else it serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  hopper::Ring<kWgStages> ring;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, across items
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int64_t next0 = parent_of(blockIdx.x, 0), next1 = parent_of(blockIdx.x, 1);
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int64_t p0 = next0, p1 = next1;  // the next item's, loaded while this one streams
        next0 = parent_of(item + gridDim.x, 0);
        next1 = parent_of(item + gridDim.x, 1);
        if (p0 < 0 && p1 < 0) continue;
        const int last = sh.p_rows - 1;  // a parent past the store reads its last row
        const int r0 = static_cast<int>(p0 < last ? p0 : last), r1 = static_cast<int>(p1 < last ? p1 : last);
        const int q_row = (item / pairs) * sh.tq_pad;
        const uint32_t bytes = kQBytes + ((p0 >= 0) + (p1 >= 0)) * kDocBytes;
        for (int pass = 0; pass < sh.n_pass; ++pass)
          for (int dt = 0; dt < sh.n_dt; ++dt)
            for (int kb = 0; kb < sh.n_k; ++kb) {
              hopper::mbar_wait(&sm.pipe.empty[ring.stage], ring.parity ^ 1);
              uint64_t* bar = &sm.pipe.full[ring.stage];
              hopper::mbar_arrive_expect_tx(bar, bytes);
              hopper::tma_load_2d(sm.pipe.b(ring.stage), &map_q, kb * hopper::kStageRowBytes,
                                  q_row + pass * kN, bar);
              uint8_t* docs = sm.pipe.a(ring.stage);
              const int col = kb * static_cast<int>(kWgKElems * sizeof(T));
              if (p0 >= 0) hopper::tma_load_3d(docs, &map_doc, col, dt * kWgDocRows, r0, bar);
              if (p1 >= 0) hopper::tma_load_3d(docs + kWgSlot, &map_doc, col, dt * kWgDocRows, r1, bar);
              ring.advance();
            }
      }
    }
    return;
  }

  // ---- consumers: consumer c scores candidate 2 j + c of each item
  hopper::reg_alloc<232>();
  const int c = wg - 1;
  const int t = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = t >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int row0 = 16 * warp + g;         // the thread's doc tokens of a tile: row0, row0 + 8
  constexpr int kCols = (kN + 127) / 128;  // query tokens of a pass a thread finishes
  constexpr int kV = kN / 4;               // row maxima a thread holds after the products
  const float scale = __bfloat162float(__float2bfloat16_rn(1.f / 127.f));  // bf16(1/127)
  const float scale_off = -8388736.f * scale;  // -(2^23 + 128) bf16(1/127), exact
  int epi = 0, cand_par = 0;
  float acc[Mma::kAcc];

  // the products of one doc-token tile against the pass's query tokens over all of D
  auto products = [&]() {
    int prev = -1;
    if constexpr (kInt8) {
      // A from registers: the lane's 16 bytes of rows row0 and row0 + 8, loaded while
      // the previous stage's wgmmas run, widened to bf16 with the scale once they are
      // done (a register a wgmma reads is defined only outside its pipeline stage)
      for (int kb = 0; kb < sh.n_k; ++kb) {
        hopper::mbar_wait(&sm.pipe.full[ring.stage], ring.parity);
        const uint8_t* doc = sm.pipe.a(ring.stage) + c * kWgSlot;
        const uint4 x = *reinterpret_cast<const uint4*>(doc + row0 * kWgKElems + 16 * c4);
        const uint4 y = *reinterpret_cast<const uint4*>(doc + (row0 + 8) * kWgKElems + 16 * c4);
        hopper::wgmma_wait<0>();  // the previous stage's wgmmas no longer read a
        sm.pipe.release(prev);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
        uint32_t a[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          widen4(xs[s], scale, scale_off, a[s][0], a[s][2]);
          widen4(ys[s], scale, scale_off, a[s][1], a[s][3]);
        }
        const uint8_t* qt = sm.pipe.b(ring.stage);
        hopper::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          Mma::rs(acc, a[s], hopper::wgmma_desc(qt, s * hopper::kMmaKBytes), (kb | s) != 0);
        hopper::wgmma_commit();
        prev = ring.stage;
        ring.advance();
      }
    } else {
      for (int kb = 0; kb < sh.n_k; ++kb) {
        hopper::mbar_wait(&sm.pipe.full[ring.stage], ring.parity);
        const uint8_t* doc = sm.pipe.a(ring.stage) + c * kWgSlot;
        const uint8_t* qt = sm.pipe.b(ring.stage);
        hopper::wgmma_fence();
#pragma unroll
        for (int k = 0; k < hopper::kStageRowBytes; k += hopper::kMmaKBytes)
          Mma::ss(acc, hopper::wgmma_desc(doc, k), hopper::wgmma_desc(qt, k), (kb | k) != 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        sm.pipe.release(prev);
        prev = ring.stage;
        ring.advance();
      }
    }
    hopper::wgmma_wait<0>();
    sm.pipe.release(prev);
  };

  int64_t next0 = parent_of(blockIdx.x, 0), next1 = parent_of(blockIdx.x, 1);
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    // broadcast, so that the compiler sees the branches on them as uniform
    const int64_t p0 = __shfl_sync(0xffffffffu, next0, 0), p1 = __shfl_sync(0xffffffffu, next1, 0);
    next0 = parent_of(item + gridDim.x, 0);
    next1 = parent_of(item + gridDim.x, 1);
    const int qb = item / pairs, j = 2 * (item - qb * pairs) + c;
    const int64_t own = c == 0 ? p0 : p1;
    float* dst = out + static_cast<int64_t>(qb) * sh.k + j;
    if (own < 0) {  // an invalid candidate scores 0; the partner's stages pass unread
      if (t == 0 && j < sh.k) *dst = 0.f;
      if (p0 >= 0 || p1 >= 0) sm.pipe.skip(ring, n_stages);
      continue;
    }
    const int64_t prow = own < sh.p_rows ? own : static_cast<int64_t>(sh.p_rows) - 1;
    const uint8_t* mrow = tok_mask + prow * sh.td;
    const float* wq = qw + static_cast<int64_t>(qb) * sh.tq;
    float num = 0.f, den = 0.f;
    for (int pass = 0; pass < sh.n_pass; ++pass) {
      float wt[kCols], run[kCols];  // the weight and running max of query token t + 128 u
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int col = t + 128 * u, i = pass * kN + col;
        wt[u] = col < kN && i < sh.tq ? wq[i] : 0.f;
        run[u] = -INFINITY;
      }
      for (int dt = 0; dt < sh.n_dt; ++dt) {
        // 0 for an unmasked doc token, -inf for a masked one or one past Td
        const int ta = dt * kWgDocRows + row0, tb = ta + 8;
        const float bias0 = ta < sh.td && mrow[ta] != 0 ? 0.f : -INFINITY;
        const float bias1 = tb < sh.td && mrow[tb] != 0 ? 0.f : -INFINITY;
        products();
        // column maxima: the thread's two rows, then the 8 lanes of its column (three
        // exchanges that halve the values a lane holds), then the four warps
        float v[kV];
#pragma unroll
        for (int n = 0; n < kN / 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) v[2 * n + h] = fmaxf(acc[4 * n + h] + bias0, acc[4 * n + 2 + h] + bias1);
        hopper::max_exchange<kV / 2, 16>(v, lane);
        hopper::max_exchange<kV / 4, 8>(v, lane);
        hopper::max_exchange<kV / 8, 4>(v, lane);
        // v[i], i < kV / 8: column 8 ((i + (kV / 8) g) >> 1) + 2 c4 + (i & 1)
        float* red = &sm.red[c][epi][0][0];
#pragma unroll
        for (int i = 0; i < kV / 8; i += 2) {
          const int col = 8 * ((i + (kV / 8) * g) >> 1) + 2 * c4;
          *reinterpret_cast<float2*>(red + warp * kN + col) = make_float2(v[i], v[i + 1]);
        }
        hopper::named_barrier(1 + c, 128);
        // one barrier an epilogue is enough: the buffers of this parity are written
        // again two epilogues on, after every thread has passed the next barrier
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int col = t + 128 * u;
          if (col < kN)
            run[u] = fmaxf(run[u], fmaxf(fmaxf(red[col], red[kN + col]), fmaxf(red[2 * kN + col], red[3 * kN + col])));
        }
        epi ^= 1;
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        num += fmaxf(run[u], 0.f) * wt[u];  // no unmasked token: max(-inf, 0) = 0
        den += wt[u];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      num += __shfl_xor_sync(0xffffffffu, num, o);
      den += __shfl_xor_sync(0xffffffffu, den, o);
    }
    if (lane == 0) {
      sm.fin[c][cand_par][warp][0] = num;
      sm.fin[c][cand_par][warp][1] = den;
    }
    hopper::named_barrier(1 + c, 128);
    if (t == 0) {
      const float(&f)[4][2] = sm.fin[c][cand_par];
      *dst = (f[0][0] + f[1][0] + f[2][0] + f[3][0]) / fmaxf(f[0][1] + f[1][1] + f[2][1] + f[3][1], 1.f);
    }
    cand_par ^= 1;
  }
}

// The opt-in to `max_smem` bytes of dynamic shared memory is made once per device.
template <typename T, bool kStaged>
int blocks_per_sm(int dev, int warps, size_t smem, int max_smem, int* per_sm) {
  static bool ready[per_device::kMaxDevices] = {};
  if (!ready[dev]) {
    cudaError_t err = cudaFuncSetAttribute(maxsim_kernel<T, kStaged>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, maxsim_kernel<T, kStaged>, warps * 32, smem));
}

struct Plan {
  int warps = 0, per_sm = 0;
  size_t smem = 0;
};

// The block size with the most warps resident on an SM, for blocks that stage
// `queries` queries (0: the general plan; the smaller block on a tie).
template <typename T>
int plan_for(int dev, int rs, int d32, int tq16, int queries, int max_smem, Plan& plan) {
  const size_t fixed = static_cast<size_t>(queries) *
                       (kMaxQ * 4 + ((static_cast<size_t>(tq16) * (d32 * 2 + 16) + 127) & ~size_t(127)));
  const size_t ring = kStages * (static_cast<size_t>(kTile) * rs + kMaskBytes + 8);  // + barriers
  Plan best;
  for (int warps = kMaxWarps; warps >= 1; warps /= 2) {
    const size_t smem = fixed + warps * ring;
    if (smem > static_cast<size_t>(max_smem)) continue;
    int per_sm = 0;
    const int err = queries > 0 ? blocks_per_sm<T, true>(dev, warps, smem, max_smem, &per_sm)
                                : blocks_per_sm<T, false>(dev, warps, smem, max_smem, &per_sm);
    if (err != 0) return err;
    if (per_sm * warps >= best.per_sm * best.warps && per_sm > 0) best = Plan{warps, per_sm, smem};
  }
  if (best.warps == 0) return -1;
  plan = best;
  return 0;
}

// Bytes between doc-token rows in shared memory for stages of `chunks` 32-element
// chunks: an odd number of chunks.
template <typename T>
int row_pitch(int chunks) {
  return static_cast<int>(sizeof(T)) * 32 * (chunks | 1);
}

// The launch of one shape: its plan, the candidates a block serves, the queries it
// stages (0: the general plan), its stages' row pitch and width and its passes' query
// tokens. A few shapes are kept per device (the engine alternates batch sizes).
struct Launch {
  int d = -1, tq = -1, b = -1, k = -1;
  Plan plan;
  int chunk = 0, queries = 0;
  int rs = 0, dc = 0, pass = 0;
};

template <typename T>
int launch_for(int dev, int d, int tq, int b, int k, int sms, int max_smem, Launch& out) {
  constexpr int kKept = 4;
  static Launch kept_of[per_device::kMaxDevices][kKept];
  static int next_of[per_device::kMaxDevices] = {};
  Launch* kept = kept_of[dev];
  int& next = next_of[dev];
  for (int i = 0; i < kKept; ++i) {
    const Launch& l = kept[i];
    if (l.d == d && l.tq == tq && l.b == b && l.k == k) {
      out = l;
      return 0;
    }
  }
  // One wave of blocks, each serving an equal run of the flattened candidates
  // (every SM gets the same work) and staging the queries its run spans. A run of
  // `chunk` consecutive candidates spans at most (chunk + k - 2) / k + 1 queries;
  // where those do not fit shared memory, runs get shorter (more than one wave).
  const int kc = (d + 31) >> 5, d32 = kc << 5, tq16 = (tq + 15) & ~15;
  const int64_t total = static_cast<int64_t>(b) * k;
  Launch l{d, tq, b, k};
  l.rs = row_pitch<T>(kc);
  l.dc = d32;
  l.pass = kMaxQ;
  int queries = 1, chunk = 1;
  int err = tq <= kMaxQ ? 0 : -1;  // -1: the staged plan does not fit
  for (int pass = 0; pass < 3 && err == 0; ++pass) {
    err = plan_for<T>(dev, l.rs, d32, tq16, queries, max_smem, l.plan);
    while (err == -1 && queries > 1) {  // fewer queries a block, shorter runs
      --queries;
      err = plan_for<T>(dev, l.rs, d32, tq16, queries, max_smem, l.plan);
    }
    if (err != 0) break;
    const int64_t blocks = static_cast<int64_t>(l.plan.per_sm) * sms;
    chunk = static_cast<int>((total + blocks - 1) / blocks);
    chunk = chunk < 32 * l.plan.warps ? chunk : 32 * l.plan.warps;  // 32 candidates a warp
    const int most = (queries - 1) * k + 1;  // the longest run that spans `queries`
    const int need = static_cast<int>((chunk + k - 2) / k) + 1;
    if (need <= queries || pass == 2 || queries == kMaxBlockQueries) {
      chunk = chunk < most ? chunk : most;
      break;
    }
    queries = need < kMaxBlockQueries ? need : kMaxBlockQueries;
  }
  if (err == -1) {
    // The general plan: no staged query; a stage holds as many 32-element chunks of
    // a row as a kMaxChunkRow-byte pitch allows, spread evenly over the row.
    int most_chunks = 1;
    while (row_pitch<T>(most_chunks + 1) <= kMaxChunkRow) ++most_chunks;
    const int stages = (kc + most_chunks - 1) / most_chunks;  // of a doc-token tile
    const int chunks = (kc + stages - 1) / stages;
    l.rs = row_pitch<T>(chunks);
    l.dc = 32 * chunks;
    l.pass = stages > 1 ? kSliceQ : kMaxQ;
    queries = 0;
    err = plan_for<T>(dev, l.rs, d32, tq16, 0, max_smem, l.plan);
    if (err != 0) return err == -1 ? static_cast<int>(cudaErrorInvalidConfiguration) : err;
    const int64_t blocks = static_cast<int64_t>(l.plan.per_sm) * sms;
    chunk = static_cast<int>((total + blocks - 1) / blocks);
    chunk = chunk < 32 * l.plan.warps ? chunk : 32 * l.plan.warps;  // 32 candidates a warp
  }
  if (err != 0) return err;
  l.chunk = chunk;
  l.queries = queries;
  kept[next] = l;
  next = (next + 1) % kKept;
  out = l;
  return 0;
}

// Tensor map of the token store: rows of 4-byte elements, boxes of 32 rows as wide
// as the padded shared-memory row (TMA zero-fills the pad and the k tail), kept per
// device and encoded again only when that device's store changes.
struct Map {
  const void* tokens = nullptr;
  uint64_t rows = 0;
  int row_bytes = 0, rs = 0;
  CUtensorMap tok;
};

int make_map(Map& m, const void* tokens, uint64_t rows, int row_bytes, int rs) {
  if (m.tokens == tokens && m.rows == rows && m.row_bytes == row_bytes && m.rs == rs) return 0;
  hopper::TensorMapEncode encode;
  const int err = hopper::tensor_map_encoder(&encode);
  if (err != 0) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes / 4), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(rs / 4), kTile};
  const cuuint32_t elem[2] = {1, 1};
  CUresult res = encode(&m.tok, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(tokens), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return hopper::kEncodeFailed + static_cast<int>(res);
  m.tokens = tokens;
  m.rows = rows;
  m.row_bytes = row_bytes;
  m.rs = rs;
  return 0;
}

// The tensor map of the store for the wgmma plan: [p_rows, td, d * E] bytes, boxes of
// 64 tokens x 64 elements of one parent (bf16: 128 bytes, swizzled as wgmma reads them;
// int8: 64 bytes, unswizzled); tokens past td and bytes past the row read as zero.
int make_doc_map(CUtensorMap* map, const void* tokens, int p_rows, int td, int row_bytes, bool int8) {
  hopper::TensorMapEncode encode;
  const int err = hopper::tensor_map_encoder(&encode);
  if (err != 0) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row_bytes), static_cast<cuuint64_t>(td),
                              static_cast<cuuint64_t>(p_rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(row_bytes) * td};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(int8 ? kWgKElems : 2 * kWgKElems), kWgDocRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(tokens), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : hopper::kEncodeFailed + static_cast<int>(res);
}

// Bytes of the rounded query buffer the wgmma plan needs: bf16[b, tq_pad, d_pad].
int64_t wgmma_scratch_bytes(int d, int tq, int b) {
  const int n = wgmma_tile_n(tq);
  return static_cast<int64_t>(b) * ((tq + n - 1) / n * n) * ((d + kWgKElems - 1) / kWgKElems * kWgKElems) * 2;
}

// The query's rounding pass and one persistent launch of the wgmma plan.
template <typename T, int kN>
int launch_wgmma(int dev, int sms, const void* tokens, const void* tok_mask, const void* parent,
                 const void* q, const void* qw, void* out, void* scratch, int p_rows, int td, int d,
                 int tq, int b, int k, cudaStream_t st) {
  constexpr int kSmem = sizeof(WgSmem<kN>) + 1024;  // room to align the ring to 1024 bytes
  static bool ready[per_device::kMaxDevices] = {};
  if (!ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(maxsim_wgmma_kernel<T, kN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const int tq_pad = (tq + kN - 1) / kN * kN, d_pad = (d + kWgKElems - 1) / kWgKElems * kWgKElems;
  const int64_t groups = static_cast<int64_t>(b) * tq_pad * (d_pad / 8);
  const int64_t most = static_cast<int64_t>(sms) * 8;
  const int rq_blocks = static_cast<int>(std::min<int64_t>((groups + 255) / 256, most));
  auto* qr = static_cast<__nv_bfloat16*>(scratch);
  round_query_kernel<sizeof(T) == 1><<<rq_blocks, 256, 0, st>>>(static_cast<const float*>(q), qr, tq,
                                                                d, tq_pad, d_pad, groups);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  CUtensorMap map_doc, map_q;
  err = make_doc_map(&map_doc, tokens, p_rows, td, d * static_cast<int>(sizeof(T)), sizeof(T) == 1);
  if (err == 0)
    err = hopper::make_tensor_map(&map_q, qr, static_cast<uint64_t>(b) * tq_pad, d_pad * 2, d_pad * 2, kN);
  if (err != 0) return err;
  const WgShape sh{p_rows, td, d, tq, b, k, tq_pad, d_pad / kWgKElems, (td + kWgDocRows - 1) / kWgDocRows,
                   tq_pad / kN};
  const int items = b * ((k + 1) / 2), grid = items < sms ? items : sms;
  maxsim_wgmma_kernel<T, kN><<<grid, kWgThreads, kSmem, st>>>(
      map_doc, map_q, static_cast<const uint8_t*>(tok_mask), static_cast<const int64_t*>(parent),
      static_cast<const float*>(qw), static_cast<float*>(out), sh);
  return static_cast<int>(cudaGetLastError());
}

enum PlanKind { kPlanStaged = 0, kPlanWgmma = 1, kPlanGeneral = 2 };

// The current device's ordinal, SM count and shared-memory opt-in limit.
int device_limits(int* dev, int* sms, int* max_smem) {
  static int sms_of[per_device::kMaxDevices] = {}, max_smem_of[per_device::kMaxDevices] = {};
  if (const cudaError_t e = per_device::current(dev); e != cudaSuccess) return static_cast<int>(e);
  int &s = sms_of[*dev], &m = max_smem_of[*dev];
  if (s == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&m, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) {
      s = 0;
      return static_cast<int>(err);
    }
  }
  *sms = s;
  *max_smem = m;
  return 0;
}

// The plan of a shape, by shape alone: the staged plan wherever it fits, else the
// wgmma plan wherever TMA reaches the rows (a multiple of 16 bytes, from a 16-byte
// aligned store: tma_rows), else the general plan.
template <typename T>
int choose(int d, int tq, int b, int k, int tma_rows, int* dev, int* sms, Launch& l, int* plan) {
  int max_smem = 0;
  int err = device_limits(dev, sms, &max_smem);
  if (err == 0) err = launch_for<T>(*dev, d, tq, b, k, *sms, max_smem, l);
  if (err != 0) return err;
  *plan = l.queries > 0 ? kPlanStaged : tma_rows != 0 ? kPlanWgmma : kPlanGeneral;
  return 0;
}

template <typename T>
int launch(const void* tokens, const void* tok_mask, const void* parent, const void* q,
           const void* qw, void* out, void* scratch, int p_rows, int td, int d, int tq, int b, int k,
           int tma_rows, void* stream) {
  if (p_rows < 1 || td < 1 || d < 1 || tq < 1 || b < 1 || k < 1 ||
      static_cast<int64_t>(p_rows) * td > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static Map maps[per_device::kMaxDevices];  // of each device's last store
  int dev = 0, sms = 0, plan = 0;
  Launch l;
  int err = choose<T>(d, tq, b, k, tma_rows, &dev, &sms, l, &plan);
  if (err != 0) return err;
  auto st = static_cast<cudaStream_t>(stream);
  if (plan == kPlanWgmma) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    switch (wgmma_tile_n(tq)) {
      case 64:
        return launch_wgmma<T, 64>(dev, sms, tokens, tok_mask, parent, q, qw, out, scratch, p_rows, td, d, tq, b, k, st);
      case 128:
        return launch_wgmma<T, 128>(dev, sms, tokens, tok_mask, parent, q, qw, out, scratch, p_rows, td, d, tq, b, k, st);
      default:
        return launch_wgmma<T, 256>(dev, sms, tokens, tok_mask, parent, q, qw, out, scratch, p_rows, td, d, tq, b, k, st);
    }
  }
  constexpr int E = sizeof(T);
  Map& map = maps[dev];
  // one TMA box per stage where TMA can address the rows (16-byte multiples from a
  // 16-byte aligned store: the caller says so) and the padded row fits a box
  const bool tma = tma_rows != 0 && l.rs <= kMaxTmaRow;
  if (tma) {
    err = make_map(map, tokens, static_cast<uint64_t>(p_rows) * td, d * E, l.rs);
    if (err != 0) return err;
  }
  const Plan& pl = l.plan;
  const int64_t total = static_cast<int64_t>(b) * k;
  Shape sh{p_rows, td, d, tq, b, k, l.chunk, l.queries, l.rs, tma, l.dc, l.pass};
  const dim3 grid(static_cast<unsigned>((total + l.chunk - 1) / l.chunk)), block(pl.warps * 32);
  const auto* tok = static_cast<const T*>(tokens);
  const auto* msk = static_cast<const uint8_t*>(tok_mask);
  const auto* pid = static_cast<const int64_t*>(parent);
  const auto* qv = static_cast<const float*>(q);
  const auto* wv = static_cast<const float*>(qw);
  auto* o = static_cast<float*>(out);
  if (plan == kPlanStaged)
    maxsim_kernel<T, true><<<grid, block, pl.smem, st>>>(map.tok, tok, msk, pid, qv, wv, o, sh);
  else
    maxsim_kernel<T, false><<<grid, block, pl.smem, st>>>(map.tok, tok, msk, pid, qv, wv, o, sh);
  return static_cast<int>(cudaGetLastError());
}

// The plan (PlanKind) a shape takes on the current device, and the bytes of scratch
// its launch needs (the wgmma plan's rounded query; else 0).
template <typename T>
int plan_of(int d, int tq, int b, int k, int tma_rows, void* plan_out, void* scratch_out) {
  if (d < 1 || tq < 1 || b < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, plan = 0;
  Launch l;
  const int err = choose<T>(d, tq, b, k, tma_rows, &dev, &sms, l, &plan);
  if (err != 0) return err;
  *static_cast<int*>(plan_out) = plan;
  *static_cast<int64_t*>(scratch_out) = plan == kPlanWgmma ? wgmma_scratch_bytes(d, tq, b) : 0;
  return 0;
}

}  // namespace

extern "C" {

// scratch: the plan's scratch (maxsim_plan_*), or null when it needs none. tma_rows: 1
// when a token row is a multiple of 16 bytes and the store 16-byte aligned, else 0.
int maxsim_scores_bf16(const void* tokens, const void* tok_mask, const void* parent,
                       const void* q, const void* qw, void* out, void* scratch, int p_rows, int td,
                       int d, int tq, int b, int k, int tma_rows, void* stream) {
  return launch<__nv_bfloat16>(tokens, tok_mask, parent, q, qw, out, scratch, p_rows, td, d, tq, b,
                               k, tma_rows, stream);
}

int maxsim_scores_int8(const void* tokens, const void* tok_mask, const void* parent,
                       const void* q, const void* qw, void* out, void* scratch, int p_rows, int td,
                       int d, int tq, int b, int k, int tma_rows, void* stream) {
  return launch<int8_t>(tokens, tok_mask, parent, q, qw, out, scratch, p_rows, td, d, tq, b, k,
                        tma_rows, stream);
}

// *plan (int): 0 the staged plan, 1 the wgmma plan, 2 the general plan; *scratch
// (int64): bytes of scratch the launch needs
int maxsim_plan_bf16(int d, int tq, int b, int k, int tma_rows, void* plan, void* scratch) {
  return plan_of<__nv_bfloat16>(d, tq, b, k, tma_rows, plan, scratch);
}

int maxsim_plan_int8(int d, int tq, int b, int k, int tma_rows, void* plan, void* scratch) {
  return plan_of<int8_t>(d, tq, b, k, tma_rows, plan, scratch);
}

}  // extern "C"
