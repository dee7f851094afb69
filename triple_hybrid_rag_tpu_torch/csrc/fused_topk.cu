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
// against the same 0.13 ms, nearly balanced. Each row is read from device memory
// once; the f32[B, N] scores stay in registers.
//
// int8 and int4 rows (csrc/wgmma_common.cuh), so that no thread instruction is
// spent on moving operands and enough bytes are in flight to cover the memory's
// latency:
// - One persistent block per SM: a producer warpgroup and three consumer
//   warpgroups. A consumer's tile is 64 corpus rows (the M of wgmma m64n128k32,
//   s8 -> s32) against up to 128 queries (the N); more queries take one launch per
//   128. The corpus rows are M so that a warp of the warpgroup owns 16 rows = one
//   bucket and so that A can come from registers (int4).
// - The queries stay resident in shared memory when they fit (128 KB at D = 1024:
//   one TMA load per block, not one per tile), and only rows stream, in stages of
//   64 rows x 128 bytes. Wider rows stream the query tile through the ring beside
//   the rows (two consumers, fewer and larger stages; the queries then come back
//   from L2 once per tile).
// - Consumer c takes tile 3p + c of the block's p-th group. Each consumer has a
//   ring (three stages) and a producer thread of its own, so the pipelines share
//   nothing but the resident queries: one's epilogue runs under the others'
//   wgmmas, and each producer runs ahead across tiles, so stores overlap loads.
//   One ring shared by consumers that take alternate tiles would need an order
//   between them: a consumer that skips the others' stages falls a lap behind the
//   ring, and an mbarrier's parity cannot tell two laps apart.
// - int8: both operands from shared memory. int4: a warp reads its 16 rows'
//   packed words from the swizzled stage (the 16-byte chunk index XOR-ed with the
//   row's index modulo 8 by hand: conflict-free), widens them in registers and
//   runs wgmma with A in registers: the low half against the resident tile of
//   query columns [c, c + 128), the high half against [D/2 + c, D/2 + c + 128).
//   The halves are two tensor maps over the same query matrix, each D/2 wide with
//   a row pitch of D, so a ragged last stage of the low half reads zeros and not
//   the high half's first columns. A zero packed byte is two zero codes, so TMA's
//   zero fill of rows >= N and columns >= D/2 adds nothing. The words of the next
//   stage are loaded while the wgmmas of this one run; the widened fragments are
//   rewritten only after wgmma_wait. A wgmma with A in registers holds its warps
//   for about twice its tensor-core time, which is why a third consumer pays.
// - Epilogue, without a branch (a short-circuit mask test per score made it four
//   times slower): a thread reads its two rows' scale, validity and collection
//   once per tile, the queries' scales and collections once per block into shared
//   memory; a masked score is min(s, -inf). The max over a bucket's 16 rows is
//   the thread's two rows, then three exchanges in which a lane hands half of its
//   values to its partner (28 shuffles a thread, not 96). A tile's maxima (128
//   queries x 4 buckets) are staged in shared memory and leave as one 16-byte
//   store per query.
//
// bf16 rows: one block owns a tile of 128 rows and 128 queries
// (csrc/tile_common.cuh: cp.async in two stages, mma.sync, f32 sums in registers);
// the 16-row bucket is one m16 tile of a warp.
//
// f32 rows (embedding_dtype "float32": the reference keeps its rows unrounded, and
// Engine serves them through this body): csrc/simt_f32.cuh, full f32 FMAs, no
// TF32. What bounds it at B = 128 is the FMA issue rate (3.91 ms at 67 TFLOP/s
// against 1.23 ms of bytes), at B = 1 the 4.1 GB of rows. Tiles of 128 rows x 128
// queries or, for B <= 16, 256 rows x 16 queries (the caller picks `q_tile`), on a
// persistent grid. Epilogue in registers: a thread masks its scores (validity and
// collection, as masked()) and takes the max over its four rows of each bucket;
// the four threads that share a bucket are lanes kTxLanes and 2 kTxLanes apart,
// and two half-exchanges leave each with the bucket's maxima of a quarter of its
// queries (one group of four rows at a time, to keep registers for the main loop).
// A tile's maxima ([bucket][query], 4 KB at most, in the row stage just consumed)
// go through shared memory only to leave as 16-byte stores of four buckets of a
// query.
//
// Interface: plain C, bound with ctypes. Every function launches on the given
// stream and returns 0, a cudaError_t (cudaGetLastError() after the launch), or
// hopper::kEncodeFailed plus the encoder's CUresult when a tensor map was refused.

#include "simt_f32.cuh"
#include "tile_common.cuh"
#include "wgmma_common.cuh"

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

struct Masks {
  const uint8_t* valid;  // [n]
  const int32_t* coll;   // [n] or null
  const int32_t* cid;    // [b] or null
};

// An m16 tile is one bucket. Lane (g, t) holds rows g and g+8 for queries 2t
// and 2t+1 of each n8 tile; the max over g takes three shuffles.
__device__ __forceinline__ void bucket_epilogue(const float (&acc)[2][8][4], const Lane& ln,
                                                const Masks& m, int row0, int q0, int n, int b,
                                                int nb, float* __restrict__ out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rbase = row0 + ln.warp_m * 32 + i * 16;
    const int r_lo = rbase + ln.g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qa = q0 + ln.warp_n * 64 + j * 8 + 2 * ln.t;
      const int qb = qa + 1;
      float ma = fmaxf(masked(acc[i][j][0], r_lo, qa, n, b, m.valid, m.coll, m.cid),
                       masked(acc[i][j][2], r_hi, qa, n, b, m.valid, m.coll, m.cid));
      float mb = fmaxf(masked(acc[i][j][1], r_lo, qb, n, b, m.valid, m.coll, m.cid),
                       masked(acc[i][j][3], r_hi, qb, n, b, m.valid, m.coll, m.cid));
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

// ---------------------------------------------------------------- bf16 rows
__global__ void __launch_bounds__(kThreads, 2)
bucket_max_bf16_kernel(const uint8_t* __restrict__ emb,  // [n, row_bytes]
                       const uint8_t* __restrict__ qv,   // [b, row_bytes]
                       Masks m, float* __restrict__ out,  // [b, nb]
                       int n, int row_bytes, int b, int nb) {
  __shared__ __align__(16) Smem sm;
  const Lane ln;
  const int row0 = blockIdx.x * BM;
  const int q0 = blockIdx.y * BN;
  float acc[2][8][4];
  mainloop(emb, qv, n, row_bytes, b, row0, q0, sm, ln, acc);
  bucket_epilogue(acc, ln, m, row0, q0, n, b, nb, out);
}

// ---------------------------------------------------------------- int8 and packed int4 rows
constexpr int kTileRows = 64;      // corpus rows of a consumer's tile: the M of one wgmma
constexpr int kTileQueries = 128;  // queries of a launch: the N of one wgmma
constexpr int kQTileBytes = kTileQueries * hopper::kStageRowBytes;  // 16 KB
constexpr int kResidentTiles = 8;  // query tiles that stay in shared memory: 128 KB

// Shared memory and shape of a block: a producer warpgroup and kConsumers consumer
// warpgroups, one ring per consumer. Resident: a ring streams rows only, three
// consumers of three stages each. Streamed: a stage also holds the k-block's query
// tile (int4: the low and the high half's), so two consumers fit.
template <bool kInt4, bool kResident>
struct IntSmem {
  static constexpr int kConsumers = kResident ? 3 : 2;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // registers a thread after setmaxnreg: the SM's 64 K over the warpgroups
  static constexpr int kProducerRegs = kResident ? 24 : 40;
  static constexpr int kConsumerRegs = kResident ? 160 : 232;
  static constexpr int kStages = kResident ? 3 : (kInt4 ? 2 : 3);
  static constexpr int kStageQueries = kResident ? 0 : (kInt4 ? 2 : 1) * kTileQueries;
  using Pipe = hopper::Pipeline<kStages, kTileRows, kStageQueries, 4>;
  Pipe pipe[kConsumers];
  alignas(1024) uint8_t q[kResident ? kResidentTiles : 1][kQTileBytes];
  alignas(8) uint64_t q_full;                  // the resident query tiles have landed
  alignas(16) float q_scale[kTileQueries];     // 0 for queries >= b
  alignas(16) int cid[kTileQueries];           // -1 (every collection) when unscoped
  alignas(16) float out[kConsumers][2][4][kTileQueries];  // [consumer][tile parity][bucket][query]
};

// scale, validity and collection of one corpus row
struct RowMeta {
  float scale;
  float limit;  // +inf, or -inf for a row that is invalid or outside the corpus
  int coll;
  __device__ __forceinline__ RowMeta(int r, int n, const float* __restrict__ scales,
                                     const Masks& m) {
    const bool in = r < n;
    scale = in ? scales[r] : 0.f;
    limit = (in && m.valid[r] != 0) ? INFINITY : -INFINITY;
    coll = (in && m.coll != nullptr) ? m.coll[r] : 0;
  }
  // (float(acc >> shift) * scale) * q_scale, or -inf for a masked row; `open` = the
  // query takes every collection (cid -1). Written without a branch: min(s, +inf)
  // is s, bit for bit.
  template <int kShift>
  __device__ __forceinline__ float score(int acc, float q_scale, bool open, int cid) const {
    float s = static_cast<float>(acc >> kShift) * scale;
    s = s * q_scale;
    return fminf(s, (open | (coll == cid)) ? limit : -INFINITY);
  }
};

// v[i] = max(v[i], the partner lane's v[i]) for the half of v[0 .. 2 kHalf) that this
// lane keeps (the upper half if its bit kBit is set), handing the other half to
// the partner, lane ^ kBit. The kept half ends in v[0 .. kHalf).
template <int kHalf, int kBit = kHalf, int kV>
__device__ __forceinline__ void max_exchange(float (&v)[kV], int lane) {
  const bool upper = (lane & kBit) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, kBit));
  }
}

// The packed-int4 main loop of one tile: acc = 16 * (rows . queries), exact. The
// warp reads its 16 rows' packed words of a stage, and while the previous stage's
// wgmmas finish, widens them to the A fragments of 2 x 4 wgmmas (low and high
// nibbles of 4 k-steps of 32 packed bytes).
template <bool kResident, typename Smem>
__device__ __forceinline__ void consume_int4(Smem& sm, typename Smem::Pipe& pipe,
                                             hopper::Ring<Smem::kStages>& ring, int k_blocks,
                                             int (&acc)[64]) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row_off = (warp * 16 + g) * hopper::kStageRowBytes;
  int prev = -1;
  for (int kb = 0; kb < k_blocks; ++kb) {
    hopper::mbar_wait(&pipe.full[ring.stage], ring.parity);
    const uint8_t* a = pipe.a(ring.stage) + row_off;
    uint32_t raw[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {  // 16-byte chunk c of rows g and g + 8, swizzled
      const int off = ((c ^ g) << 4) + 4 * t;
      raw[2 * c] = *reinterpret_cast<const uint32_t*>(a + off);
      raw[2 * c + 1] = *reinterpret_cast<const uint32_t*>(a + 8 * hopper::kStageRowBytes + off);
    }
    hopper::wgmma_wait<0>();  // the previous stage's wgmmas no longer read lo / hi
    pipe.release(prev);
    uint32_t lo[4][4], hi[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        lo[k][v] = (raw[4 * k + v] << 4) & 0xF0F0F0F0u;  // 16 * low-nibble code, per byte
        hi[k][v] = raw[4 * k + v] & 0xF0F0F0F0u;         // 16 * high-nibble code, per byte
      }
    const uint8_t* q_lo = kResident ? sm.q[2 * kb] : pipe.b(ring.stage);
    const uint8_t* q_hi = kResident ? sm.q[2 * kb + 1] : pipe.b(ring.stage) + kQTileBytes;
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      hopper::WgmmaS8N128::mma_rs(acc, lo[k], hopper::wgmma_desc(q_lo, k * hopper::kMmaKBytes),
                                  (kb | k) != 0);
      hopper::WgmmaS8N128::mma_rs(acc, hi[k], hopper::wgmma_desc(q_hi, k * hopper::kMmaKBytes), 1);
    }
    hopper::wgmma_commit();
    prev = ring.stage;
    ring.advance();
  }
  hopper::wgmma_wait<0>();
  pipe.release(prev);
}

template <bool kInt4, bool kResident>
__global__ void __launch_bounds__((IntSmem<kInt4, kResident>::kThreads), 1)
bucket_max_int_kernel(const __grid_constant__ CUtensorMap map_rows,  // [n, row bytes]
                      const __grid_constant__ CUtensorMap map_q,     // int8: [b, d]; int4: columns [0, d/2)
                      const __grid_constant__ CUtensorMap map_q_hi,  // int4: columns [d/2, d)
                      const float* __restrict__ scales,              // [n]
                      const float* __restrict__ q_scale,             // [b]
                      Masks m, float* __restrict__ out,              // [b, nb]
                      int n, int b, int nb, int k_blocks) {
  using Smem = IntSmem<kInt4, kResident>;
  constexpr int kConsumers = Smem::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) {
    hopper::mbar_init(&sm.q_full, 1);
    for (int c = 0; c < kConsumers; ++c) sm.pipe[c].init();
  }
  if (threadIdx.x < kTileQueries) {
    const int q = threadIdx.x;
    sm.q_scale[q] = q < b ? q_scale[q] : 0.f;
    sm.cid[q] = (m.coll != nullptr && q < b) ? m.cid[q] : -1;
  }
  __syncthreads();

  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  // the warpgroup's index, broadcast so that the compiler sees the roles' control
  // flow as uniform across a warp (else it serializes the wgmmas)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  hopper::Ring<Smem::kStages> ring;

  if (wg == 0) {
    // ---- producers: lane 0 of warp c keeps consumer c's ring full, across tile
    // boundaries
    hopper::reg_dealloc<Smem::kProducerRegs>();
    if (threadIdx.x == 0 && kResident) {
      const int tiles = (kInt4 ? 2 : 1) * k_blocks;
      hopper::mbar_arrive_expect_tx(&sm.q_full, tiles * kQTileBytes);
      for (int kb = 0; kb < k_blocks; ++kb) {
        const int col = kb * hopper::kStageRowBytes;
        if (kInt4) {
          hopper::tma_load_2d(sm.q[2 * kb], &map_q, col, 0, &sm.q_full);
          hopper::tma_load_2d(sm.q[2 * kb + 1], &map_q_hi, col, 0, &sm.q_full);
        } else {
          hopper::tma_load_2d(sm.q[kb], &map_q, col, 0, &sm.q_full);
        }
      }
    }
    if ((threadIdx.x & 31) == 0 && threadIdx.x < 32 * kConsumers) {
      const int c = threadIdx.x >> 5;  // the consumer this thread feeds
      for (int tile = kConsumers * blockIdx.x + c; tile < n_tiles; tile += kConsumers * gridDim.x) {
        sm.pipe[c].produce(ring, k_blocks, [&](int kb, uint8_t* a, uint8_t* bq, uint64_t* bar) {
          const int col = kb * hopper::kStageRowBytes;
          hopper::tma_load_2d(a, &map_rows, col, tile * kTileRows, bar);
          if (!kResident) {
            hopper::tma_load_2d(bq, &map_q, col, 0, bar);
            if (kInt4) hopper::tma_load_2d(bq + kQTileBytes, &map_q_hi, col, 0, bar);
          }
        });
      }
    }
  } else {
    // ---- consumers: consumer c takes tile kConsumers * p + c of the block's p-th group
    hopper::reg_alloc<Smem::kConsumerRegs>();
    const int c = wg - 1;
    typename Smem::Pipe& pipe = sm.pipe[c];
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int q_own = threadIdx.x & 127;  // the query whose maxima this thread stores
    const bool vec = (nb & 3) == 0;       // 16-byte stores stay aligned in every output row
    if (kResident) hopper::mbar_wait(&sm.q_full, 0);
    int parity = 0;
    int acc[64];
    for (int tile = kConsumers * blockIdx.x + c; tile < n_tiles; tile += kConsumers * gridDim.x) {
      const int r_lo = tile * kTileRows + warp * 16 + g;
      const RowMeta lo(r_lo, n, scales, m), hi(r_lo + 8, n, scales, m);
      if (kInt4) {
        consume_int4<kResident>(sm, pipe, ring, k_blocks, acc);
      } else {
        pipe.template consume<hopper::WgmmaS8N128>(
            ring, 0, k_blocks, acc,
            [&](int kb, const uint8_t* bq) { return kResident ? sm.q[kb] : bq; });
      }
      // The warp's 16 rows are one bucket. Max over the thread's two rows for its 32
      // queries, then over the 8 lanes that share t: in each of three exchanges a
      // lane hands half of its values to its partner and keeps the maxima of the
      // other half, so lane (g, t) ends with the bucket's maxima of 4 queries.
      constexpr int kShift = kInt4 ? 4 : 0;
      float v[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int q = 8 * j + 2 * t;
        const float2 qs = *reinterpret_cast<const float2*>(&sm.q_scale[q]);
        const int2 qc = *reinterpret_cast<const int2*>(&sm.cid[q]);
        const bool open_x = qc.x == -1, open_y = qc.y == -1;
        v[2 * j] = fmaxf(lo.score<kShift>(acc[4 * j], qs.x, open_x, qc.x),
                         hi.score<kShift>(acc[4 * j + 2], qs.x, open_x, qc.x));
        v[2 * j + 1] = fmaxf(lo.score<kShift>(acc[4 * j + 1], qs.y, open_y, qc.y),
                             hi.score<kShift>(acc[4 * j + 3], qs.y, open_y, qc.y));
      }
      max_exchange<16>(v, lane);
      max_exchange<8>(v, lane);
      max_exchange<4>(v, lane);
      // v[i], i < 4, now belongs to query 16 g + 8 (i / 2) + 2 t + i % 2; staged as
      // [bucket of the tile][query]
      float* stage = &sm.out[c][parity][0][0];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        stage[warp * kTileQueries + 16 * g + 8 * (i >> 1) + 2 * t + (i & 1)] = v[i];
      hopper::named_barrier(1 + c, 128);
      // one barrier a tile is enough: the buffer of this parity is written again
      // two tiles on, after every thread has passed the next tile's barrier
      if (q_own < b) {
        const int bucket = tile * (kTileRows / kBucket);
        float* dst = out + (size_t)q_own * nb + bucket;
        const float4 r = make_float4(stage[q_own], stage[kTileQueries + q_own],
                                     stage[2 * kTileQueries + q_own], stage[3 * kTileQueries + q_own]);
        if (vec) {
          *reinterpret_cast<float4*>(dst) = r;
        } else {
          if (bucket < nb) dst[0] = r.x;
          if (bucket + 1 < nb) dst[1] = r.y;
          if (bucket + 2 < nb) dst[2] = r.z;
          if (bucket + 3 < nb) dst[3] = r.w;
        }
      }
      parity ^= 1;
    }
  }
}

// ---------------------------------------------------------------- f32 rows
template <int kQ>
__global__ void __launch_bounds__(simt::Shape<kQ>::kThreads, simt::Shape<kQ>::kMinBlocks)
bucket_max_f32_kernel(const float* __restrict__ emb, const float* __restrict__ qv, Masks m,
                      float* __restrict__ out, int n, int d, int b, int nb) {
  using T = simt::Tile<kQ>;
  constexpr int kTN = T::kTN;
  constexpr int kLane0 = T::kTxLanes;  // lane bit of a row quad's bit 0 in a bucket
  extern __shared__ float4 f32_smem[];
  const bool vec = (nb & 3) == 0;  // 16-byte stores stay aligned in every output row
  simt::run<kQ>(emb, qv, n, d, b, reinterpret_cast<float*>(f32_smem),
                [&](auto& acc, const auto& p, int row0, int q0, float* scratch) {
    int cid[kTN];  // -1: every collection
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int q = q0 + p.query(c);
      cid[c] = (m.coll != nullptr && q < b) ? m.cid[q] : -1;
    }
    // the tile's maxima, [bucket][query], in the row stage every thread has consumed
    float(&stage)[T::kBuckets][kQ] = *reinterpret_cast<float(*)[T::kBuckets][kQ]>(scratch);
    __syncthreads();
    // after the exchanges v[i], i < kTN / 4, is the bucket's maximum for query c = o0 + i
    const int o0 = ((p.lane & (2 * kLane0)) ? kTN / 2 : 0) + ((p.lane & kLane0) ? kTN / 4 : 0);
#pragma unroll
    for (int g = 0; g < T::kRowGroups; ++g) {
      float v[kTN];
#pragma unroll
      for (int c = 0; c < kTN; ++c) v[c] = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + p.row(4 * g + i);
        const bool in = r < n && m.valid[r] != 0;
        const int coll = (in && m.coll != nullptr) ? m.coll[r] : 0;
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const bool keep = in && (cid[c] == -1 || coll == cid[c]);
          v[c] = fmaxf(v[c], keep ? acc[4 * g + i][c] : -INFINITY);
        }
      }
      max_exchange<kTN / 2, 2 * kLane0>(v, p.lane);
      max_exchange<kTN / 4, kLane0>(v, p.lane);
#pragma unroll
      for (int i = 0; i < kTN / 4; ++i)
        stage[g * (T::kThreadsR / 4) + p.ty / 4][p.query(o0 + i)] = v[i];
    }
    __syncthreads();
    // four buckets of one query per store; the stage is written again only after
    // the next stage's barrier
    for (int e = threadIdx.x; e < kQ * T::kBuckets / 4; e += T::kThreads) {
      const int ql = e % kQ, grp = e / kQ;
      const int q = q0 + ql, bucket = row0 / 16 + 4 * grp;
      if (q >= b || bucket >= nb) continue;
      const float4 r = make_float4(stage[4 * grp][ql], stage[4 * grp + 1][ql],
                                   stage[4 * grp + 2][ql], stage[4 * grp + 3][ql]);
      float* dst = out + (size_t)q * nb + bucket;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = r;
      } else {
        dst[0] = r.x;
        if (bucket + 1 < nb) dst[1] = r.y;
        if (bucket + 2 < nb) dst[2] = r.z;
        if (bucket + 3 < nb) dst[3] = r.w;
      }
    }
  });
}

template <int kQ>
int launch_f32(const void* emb, const void* q, const Masks& m, void* out, int n, int d, int b,
               cudaStream_t stream) {
  using T = simt::Tile<kQ>;
  static int cap = 0;  // resident blocks of this width
  if (cap == 0) {
    const cudaError_t err =
        simt::resident_blocks(bucket_max_f32_kernel<kQ>, T::kThreads, T::kSmemBytes, &cap);
    if (err != cudaSuccess) {
      cap = 0;
      return static_cast<int>(err);
    }
  }
  bucket_max_f32_kernel<kQ><<<simt::grid_size<kQ>(n, b, cap), T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const float*>(emb), static_cast<const float*>(q), m, static_cast<float*>(out),
      n, d, b, (n + kBucket - 1) / kBucket);
  return static_cast<int>(cudaGetLastError());
}

Masks masks(const void* valid, const void* coll, const void* cid) {
  return Masks{static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(coll),
               static_cast<const int32_t*>(cid)};
}

// One persistent launch of the variant for up to 128 queries.
template <bool kInt4, bool kResident>
int launch_int_kernel(const CUtensorMap& map_rows, const CUtensorMap& map_q,
                      const CUtensorMap& map_q_hi, const float* scales, const float* q_scale,
                      const Masks& m, float* out, int n, int b, int nb, int k_blocks,
                      cudaStream_t stream) {
  using Smem = IntSmem<kInt4, kResident>;
  constexpr int kSmemBytes = sizeof(Smem) + 1024;  // room to align to 1024 bytes
  static int sm_count = 0;
  if (sm_count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bucket_max_int_kernel<kInt4, kResident>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) {
      sm_count = 0;
      return static_cast<int>(err);
    }
  }
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int groups = (n_tiles + Smem::kConsumers - 1) / Smem::kConsumers;
  bucket_max_int_kernel<kInt4, kResident>
      <<<groups < sm_count ? groups : sm_count, Smem::kThreads, kSmemBytes, stream>>>(
          map_rows, map_q, map_q_hi, scales, q_scale, m, out, n, b, nb, k_blocks);
  return static_cast<int>(cudaGetLastError());
}

// int8 rows [n, d] or packed int4 rows [n, d / 2]: one launch per 128 queries.
template <bool kInt4>
int launch_int(const void* emb, const void* scales, const void* q, const void* q_scale,
               const void* valid, const void* coll, const void* cid, void* out, int n, int d,
               int b, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  const int row_bytes = kInt4 ? d / 2 : d;  // of a corpus row, and of a band of query columns
  const int k_blocks = (row_bytes + hopper::kStageRowBytes - 1) / hopper::kStageRowBytes;
  const bool resident = (kInt4 ? 2 : 1) * k_blocks <= kResidentTiles;
  const int nb = (n + kBucket - 1) / kBucket;
  const Masks m = masks(valid, coll, cid);
  CUtensorMap map_rows, map_q, map_q_hi;
  int err = hopper::make_tensor_map(&map_rows, emb, n, row_bytes, row_bytes, kTileRows);
  for (int q0 = 0; q0 < b && err == 0; q0 += kTileQueries) {
    const int bt = b - q0 < kTileQueries ? b - q0 : kTileQueries;
    const uint8_t* qt = static_cast<const uint8_t*>(q) + (size_t)q0 * d;
    err = hopper::make_tensor_map(&map_q, qt, bt, row_bytes, d, kTileQueries);
    if (err == 0)  // int8: unused, a copy of map_q
      err = hopper::make_tensor_map(&map_q_hi, qt + (kInt4 ? row_bytes : 0), bt, row_bytes, d,
                                    kTileQueries);
    if (err != 0) break;
    const Masks mt{m.valid, m.coll, m.cid == nullptr ? nullptr : m.cid + q0};
    const auto launch = resident ? launch_int_kernel<kInt4, true> : launch_int_kernel<kInt4, false>;
    err = launch(map_rows, map_q, map_q_hi, static_cast<const float*>(scales),
                 static_cast<const float*>(q_scale) + q0, mt,
                 static_cast<float*>(out) + (size_t)q0 * nb, n, bt, nb, k_blocks,
                 static_cast<cudaStream_t>(stream));
  }
  return err;
}

}  // namespace

extern "C" {

int fused_bucket_maxima_bf16(const void* emb, const void* q, const void* valid,
                             const void* coll, const void* cid, void* out, int n, int d,
                             int b, void* stream) {
  const int nb = (n + kBucket - 1) / kBucket;
  dim3 grid((n + BM - 1) / BM, (b + BN - 1) / BN);
  bucket_max_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(emb), static_cast<const uint8_t*>(q), masks(valid, coll, cid),
      static_cast<float*>(out), n, d * 2, b, nb);
  return static_cast<int>(cudaGetLastError());
}

// int8 rows [n, d] with row scales, int8 queries [b, d] with query scales
int fused_bucket_maxima_int8(const void* emb, const void* scales, const void* q,
                             const void* q_scale, const void* valid, const void* coll,
                             const void* cid, void* out, int n, int d, int b, void* stream) {
  return launch_int<false>(emb, scales, q, q_scale, valid, coll, cid, out, n, d, b, stream);
}

// packed int4 rows [n, d / 2] with row scales, int8 queries [b, d] with query scales
int fused_bucket_maxima_int4(const void* emb, const void* scales, const void* q,
                             const void* q_scale, const void* valid, const void* coll,
                             const void* cid, void* out, int n, int d, int b, void* stream) {
  return launch_int<true>(emb, scales, q, q_scale, valid, coll, cid, out, n, d, b, stream);
}

// f32 rows [n, d] (d a multiple of 4), f32 queries [b, d]; q_tile (16 or 128) is
// the query-tile width, which the caller picks from b
int fused_bucket_maxima_f32(const void* emb, const void* q, const void* valid,
                            const void* coll, const void* cid, void* out, int n, int d, int b,
                            int q_tile, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  const Masks m = masks(valid, coll, cid);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_tile == 16) return launch_f32<16>(emb, q, m, out, n, d, b, s);
  if (q_tile == 128) return launch_f32<128>(emb, q, m, out, n, d, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
