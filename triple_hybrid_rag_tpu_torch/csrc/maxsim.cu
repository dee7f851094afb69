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
// Design:
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
//   (plain loads for the rest, which no engine shape has). The tile's mask bytes
//   come by 4-byte cp.async. Both report to the stage's mbarrier (TMA by its
//   byte count, cp.async by cp.async.mbarrier.arrive), the only wait. Tiles
//   copied by per-lane 16-byte cp.async kept the memory less busy than TMA boxes.
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
// - Shapes: any Td, Tq and D, as the reference's einsum. The score is separable
//   over query tokens (sum_i max(per_q[i], 0) w[i], divided once at the end), so
//   the query tokens can be walked in passes, and a dot product can be summed over
//   chunks of D before its max is taken. The launcher takes the staged plan above
//   wherever it fits (Tq <= 128 and one staged query beside a one-warp ring of
//   whole rows; blocks whose runs would span more queries than fit take shorter
//   runs), else the general plan, the same kernel instantiated with kStaged false
//   (compiled as one, both plans took the general plan's registers, which cost the
//   staged plan resident warps and time at the served shapes):
//   - no query is staged: a lane builds its A fragments from the f32 query in
//     device memory (rows g and g + 8, elements 8 c4 + 4 s .. + 3 of the chunk, in
//     the k order the doc fragments use), so the query's size does not matter;
//     blocks stride the flattened candidates (block i: i, i + grid, ...) instead of
//     serving runs, so that the blocks resident at once read the rows of a few
//     queries (again for every doc-token tile), not of all of them;
//   - a stage holds 32 doc tokens x a chunk of the row, at most 384 bytes wide
//     (bf16: 160 elements, int8: 352), so that two blocks of four warps fit an SM
//     whatever D is, and a TMA box reaches every such row;
//   - when a row takes one stage, a pass covers 128 query tokens as the staged
//     plan does; when it takes more, a pass covers 32 (the accumulators of one
//     32-token slice against the tile, kept across the row's stages) and the
//     candidate's doc tokens stream once per pass (8 times at Tq = 256, D = 1024).
//   The general plan is correct at every shape, not fast: at Tq = 256, D = 1024 it
//   reads 18x its bound (PERF.md).
//
// Interface: plain C, bound with ctypes; launches on the given stream and
// returns cudaGetLastError() as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <typename T>
int launch(const void* tokens, const void* tok_mask, const void* parent, const void* q,
           const void* qw, void* out, int p_rows, int td, int d, int tq, int b, int k,
           int tma_rows, void* stream) {
  if (p_rows < 1 || td < 1 || d < 1 || tq < 1 || b < 1 || k < 1 ||
      static_cast<int64_t>(p_rows) * td > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms_of[per_device::kMaxDevices] = {}, max_smem_of[per_device::kMaxDevices] = {};
  static Map maps[per_device::kMaxDevices];  // of each device's last store
  int dev = 0;
  if (const cudaError_t e = per_device::current(&dev); e != cudaSuccess) return static_cast<int>(e);
  int &sms = sms_of[dev], &max_smem = max_smem_of[dev];  // of the current device
  Map& map = maps[dev];
  if (sms == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  constexpr int E = sizeof(T);
  Launch l;
  int err = launch_for<T>(dev, d, tq, b, k, sms, max_smem, l);
  if (err != 0) return err;
  // one TMA box per stage where TMA can address the rows (16-byte multiples from a
  // 16-byte aligned store: the caller says so) and the padded row fits a box
  const bool tma = tma_rows != 0 && l.rs <= kMaxTmaRow;
  if (tma) {
    err = make_map(map, tokens, static_cast<uint64_t>(p_rows) * td, d * E, l.rs);
    if (err != 0) return err;
  }
  const Plan& plan = l.plan;
  const int64_t total = static_cast<int64_t>(b) * k;
  Shape sh{p_rows, td, d, tq, b, k, l.chunk, l.queries, l.rs, tma, l.dc, l.pass};
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((total + l.chunk - 1) / l.chunk)), block(plan.warps * 32);
  const auto* tok = static_cast<const T*>(tokens);
  const auto* msk = static_cast<const uint8_t*>(tok_mask);
  const auto* pid = static_cast<const int64_t*>(parent);
  const auto* qv = static_cast<const float*>(q);
  const auto* wv = static_cast<const float*>(qw);
  auto* o = static_cast<float*>(out);
  if (l.queries > 0)
    maxsim_kernel<T, true><<<grid, block, plan.smem, st>>>(map.tok, tok, msk, pid, qv, wv, o, sh);
  else
    maxsim_kernel<T, false><<<grid, block, plan.smem, st>>>(map.tok, tok, msk, pid, qv, wv, o, sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tma_rows: 1 when a token row is a multiple of 16 bytes and the store 16-byte
// aligned (the tiles then come by TMA), else 0
int maxsim_scores_bf16(const void* tokens, const void* tok_mask, const void* parent,
                       const void* q, const void* qw, void* out, int p_rows, int td, int d,
                       int tq, int b, int k, int tma_rows, void* stream) {
  return launch<__nv_bfloat16>(tokens, tok_mask, parent, q, qw, out, p_rows, td, d, tq, b, k,
                               tma_rows, stream);
}

int maxsim_scores_int8(const void* tokens, const void* tok_mask, const void* parent,
                       const void* q, const void* qw, void* out, int p_rows, int td, int d,
                       int tq, int b, int k, int tma_rows, void* stream) {
  return launch<int8_t>(tokens, tok_mask, parent, q, qw, out, p_rows, td, d, tq, b, k, tma_rows,
                        stream);
}

}  // extern "C"
