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
// The TPU kernel scores one query per pass over the table and compares every
// slot with every query term. Here the table is read once per 128 queries and
// every slot is looked up once.
//
// What bounds it on an H100 at N = 1,000,448, L = 128, Q = 16, B = 128: bytes.
// The 1.02 GB table read once and 0.51 GB of scores written take 0.46 ms at 3.35
// TB/s. What the design does to stay near that:
//
// - A membership table per block of 128 queries, in shared memory: an
//   open-addressed hash (linear probing, at most half full) from term id to a
//   128-bit mask of the block's queries that hold the term. A table slot costs
//   one probe, whatever the number of queries and of terms per query. DOC_PAD
//   marks an empty entry (no query holds it, and table slots that hold it are
//   skipped before the probe); QUERY_PAD is a key like any other, so a table id
//   of -1 matches exactly the queries that have an empty slot. A term repeated
//   in a query sets its bit once.
// - A persistent grid, one block per SM: a block builds its membership table once
//   (atomicCAS on the keys, atomicOr on the masks) and then walks tiles of 32
//   rows.
// - A warp per table row. The lanes read 32 adjacent slots of ids and of weights
//   (128 slots are loaded ahead of the row in work), each lane probes its own
//   slot, a ballot collects the slots that hit, and the warp walks the hits in
//   slot order: the hit's mask is one broadcast read, and lane i adds the weight
//   to its queries i, i+32, i+64, i+96 where their bits are set. Slot order keeps
//   every score's f32 sum in the order of the table's slots. What is left above
//   the bytes is the latency of that walk (shuffle, shared-memory read, add), so
//   the probes of all loaded chunks are issued before the first walk, and a walk
//   reads the masks of two hits before it adds them.
// - Full-line stores: a row ends as 128 scores that lie N floats apart in
//   out[b, n], so four warps (a group) stage their tile's 32 rows as [query][row]
//   in shared memory (rows padded to 33 floats: no bank conflicts either way) and
//   write 128 contiguous bytes per query. A group waits only for its own four
//   warps (a named barrier), and the block holds as many groups as fit beside
//   the membership table, at most eight: rows differ in their number of hits,
//   and under a barrier over the whole block every warp waits for the tile's
//   slowest row.
//
// Interface: plain C, bound with ctypes. The function launches on the given
// stream and returns a cudaError_t (cudaGetLastError() after the launch) as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDocPad = -2;
constexpr int kQueries = 128;        // queries per block: the width of a mask
constexpr int kGroupWarps = 4;       // warps that share a tile and its staged scores
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kMaxGroups = 8;        // groups per block: 1,024 threads
constexpr int kTileRows = 32;        // table rows per tile: one output line per query
constexpr int kPitch = kTileRows + 1;  // staged scores of a query, padded
constexpr int kAhead = 4;            // chunks of 32 slots a warp loads at once
constexpr int kHits = 2;             // hits whose masks a warp reads before it adds them
constexpr int kMaxTerms = 32;        // query slots: 2 * 128 * 32 entries of 20 bytes fit
constexpr int kMinLog2 = 6;

template <typename W>
__device__ __forceinline__ float widen(W w);
template <>
__device__ __forceinline__ float widen<float>(float w) { return w; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

// entries of the membership table: the next power of two >= 2 * 128 * q
inline int table_log2(int q) {
  int log2 = kMinLog2;
  while ((1 << log2) < 2 * kQueries * q) ++log2;
  return log2;
}

constexpr size_t kStagedBytes = kQueries * kPitch * sizeof(float);  // of one group

inline size_t table_bytes(int log2) {
  return ((size_t)1 << log2) * (sizeof(uint4) + sizeof(int32_t));
}

// the warps of one group wait for each other, and for no other group
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "n"(kGroupThreads) : "memory");
}

__device__ __forceinline__ uint32_t slot_of(int32_t term, int log2) {
  return (static_cast<uint32_t>(term) * 2654435761u) >> (32 - log2);
}

template <typename W>
__global__ void __launch_bounds__(kMaxGroups * kGroupThreads, 1)
termtable_kernel(const int32_t* __restrict__ ids,    // [n, l]
                 const W* __restrict__ weights,      // [n, l]
                 const int32_t* __restrict__ query,  // [b, q]
                 float* __restrict__ out,            // [b, n]
                 int n, int l, int b, int q, int log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t size = 1u << log2;
  uint4* masks = reinterpret_cast<uint4*>(smem);           // [size] queries holding the key
  int32_t* keys = reinterpret_cast<int32_t*>(masks + size);  // [size] term id, kDocPad = empty
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid / kGroupThreads, warp = (tid >> 5) % kGroupWarps;
  const int n_groups = blockDim.x / kGroupThreads;
  // [kQueries][kPitch] scores of the group's tile
  float* staged = reinterpret_cast<float*>(keys + size) + group * (kQueries * kPitch);
  const int q0 = blockIdx.y * kQueries;
  const uint32_t mine = 1u << lane;  // this lane's bit in each word of a mask

  // ---- the block's membership table
  for (uint32_t e = tid; e < size; e += blockDim.x) {
    keys[e] = kDocPad;
    masks[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  uint32_t* mask_words = reinterpret_cast<uint32_t*>(masks);
  for (int e = tid; e < kQueries * q; e += blockDim.x) {
    const int qq = e / q, qi = q0 + qq;
    if (qi >= b) break;
    const int32_t term = query[(size_t)qi * q + e % q];
    if (term == kDocPad) continue;
    uint32_t h = slot_of(term, log2);
    for (uint32_t probe = 0; probe < size; ++probe) {
      const int32_t seen = atomicCAS(&keys[h], kDocPad, term);
      if (seen == kDocPad || seen == term) {
        atomicOr(&mask_words[4 * h + (qq >> 5)], 1u << (qq & 31));
        break;
      }
      h = (h + 1) & (size - 1);
    }
  }
  __syncthreads();

  // ---- the scan. The block's groups of four warps walk the tiles independently.
  // A warp's work is a list of (tile, row of the tile, piece of kAhead chunks of
  // the row); the next item's slots are loaded before the current item is worked on.
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  const int pieces = (l + 32 * kAhead - 1) / (32 * kAhead);
  const int first_tile = blockIdx.x * n_groups + group, tile_step = gridDim.x * n_groups;
  int next_tile = first_tile, next_rr = warp, next_g = 0;
  int32_t next_id[kAhead];
  float next_w[kAhead];
  auto load_next = [&]() {
    const int row = next_tile * kTileRows + next_rr;
    const bool live = next_tile < n_tiles && row < n;
#pragma unroll
    for (int c = 0; c < kAhead; ++c) {
      const int s = (next_g * kAhead + c) * 32 + lane;
      const bool ok = live && s < l;
      next_id[c] = ok ? ids[(size_t)row * l + s] : kDocPad;
      next_w[c] = ok ? widen<W>(weights[(size_t)row * l + s]) : 0.f;
    }
    if (++next_g == pieces) {
      next_g = 0;
      next_rr += kGroupWarps;
      if (next_rr >= kTileRows) {
        next_rr = warp;
        next_tile += tile_step;
      }
    }
  };
  load_next();

  for (int tile = first_tile; tile < n_tiles; tile += tile_step) {
    const int row0 = tile * kTileRows;
    for (int rr = warp; rr < kTileRows; rr += kGroupWarps) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // queries lane, lane+32, lane+64, lane+96
      for (int g = 0; g < pieces; ++g) {
        int32_t id[kAhead];
        float w[kAhead];
#pragma unroll
        for (int c = 0; c < kAhead; ++c) {
          id[c] = next_id[c];
          w[c] = next_w[c];
        }
        load_next();
        int found[kAhead];
#pragma unroll
        for (int c = 0; c < kAhead; ++c) {
          found[c] = -1;
          if (id[c] != kDocPad) {
            uint32_t h = slot_of(id[c], log2);
            for (uint32_t probe = 0; probe < size; ++probe) {
              const int32_t key = keys[h];
              if (key == id[c]) found[c] = static_cast<int>(h);
              if (key == id[c] || key == kDocPad) break;
              h = (h + 1) & (size - 1);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kAhead; ++c) {
          unsigned hits = __ballot_sync(0xffffffffu, found[c] >= 0);
          while (hits) {  // in slot order, kHits at a time
            const int first = __ffs(hits) - 1;
            uint4 m[kHits];
            float ws[kHits];
#pragma unroll
            for (int u = 0; u < kHits; ++u) {
              const bool on = hits != 0;
              const int src = on ? __ffs(hits) - 1 : first;
              hits &= hits - 1;
              m[u] = masks[__shfl_sync(0xffffffffu, found[c], src)];
              const float wu = __shfl_sync(0xffffffffu, w[c], src);
              ws[u] = on ? wu : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kHits; ++u) {
              if (m[u].x & mine) acc[0] += ws[u];
              if (m[u].y & mine) acc[1] += ws[u];
              if (m[u].z & mine) acc[2] += ws[u];
              if (m[u].w & mine) acc[3] += ws[u];
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) staged[(lane + 32 * k) * kPitch + rr] = acc[k];
    }
    group_sync(group);
    // 32 rows of one query are one 128-byte line of out
    for (int qq = warp; qq < kQueries; qq += kGroupWarps) {
      const int qi = q0 + qq;
      if (qi < b && row0 + lane < n) out[(size_t)qi * n + row0 + lane] = staged[qq * kPitch + lane];
    }
    group_sync(group);
  }
}

template <typename W>
int launch(const void* ids, const void* weights, const void* query, void* out, int n, int l,
           int b, int q, void* stream) {
  if (n < 1 || l < 1 || b < 1 || q < 1 || q > kMaxTerms)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0, max_smem = 0;  // of the current device
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(termtable_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 max_smem);
    if (err != cudaSuccess) {
      sms = 0;
      return static_cast<int>(err);
    }
  }
  // one block per SM: the membership table, and as many groups as fit beside it
  const int log2 = table_log2(q);
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  int groups = static_cast<int>((max_smem - table_bytes(log2)) / kStagedBytes);
  groups = groups < kMaxGroups ? groups : kMaxGroups;
  groups = groups < n_tiles ? groups : n_tiles;
  if (groups < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int blocks = (n_tiles + groups - 1) / groups;
  dim3 grid(blocks < sms ? blocks : sms, (b + kQueries - 1) / kQueries);
  termtable_kernel<W><<<grid, groups * kGroupThreads, table_bytes(log2) + groups * kStagedBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const W*>(weights),
      static_cast<const int32_t*>(query), static_cast<float*>(out), n, l, b, q, log2);
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
