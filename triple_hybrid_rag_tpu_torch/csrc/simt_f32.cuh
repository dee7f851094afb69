// Full-f32 tile loop of the f32-row bodies: `bucket_max_f32_kernel`
// (csrc/fused_topk.cu) and `dense_scores_f32_kernel` (csrc/dense_scores.cu).
//
// Both compute rows . queries for f32 rows e[N, D] and f32 queries q[B, D] with
// plain f32 FMAs: no TF32 and no split, because the reference's f32 rows round
// nothing. The FMAs run on the SIMT cores (67 TFLOP/s on an H100 SXM), so at
// B = 128 the bound is the FMA issue rate (2 B N D / 67e12 = 3.91 ms at
// N = 1,000,448, D = 1024), not the 4.1 GB of rows (1.22 ms). At B = 1 it is the
// rows' bytes.
//
// What the loop it replaces lost to (a 64 x 64 tile, 8 scalar shared-memory loads
// per 16 FMAs, one stage, every row read twice at B = 128), and what this one does:
//
// - Operand bandwidth. The SM's 128 FMA lanes take 4 operands a clock for every
//   float the shared memory delivers (128 bytes a clock), so a thread must do
//   more than 4 FMAs per float it loads. kQ = 128: a block of 128 threads owns 128
//   corpus rows x 128 queries, a thread 16 rows x 8 queries, and per 4 columns it
//   loads 8 queries' and 16 rows' 16 bytes (24 loads) for 512 FMAs, 5.3 FMAs a
//   float; the sums take the thread's registers, so two blocks share an SM and
//   one's barrier waits under the other's FMAs. Each row is read from device
//   memory once at B <= 128. kQ = 16 (256 threads, 256 rows, 4 x 4 a thread) for
//   B <= 16, where the wide tile would spend up to 127/128 of its FMAs on absent
//   queries and the rows' bytes are the bound.
// - Latency. Stages of 16 columns of the block's rows and queries are copied into
//   shared memory by cp.async (16 bytes a thread, zero-filled past N, B and D),
//   kStages - 1 stages ahead of the FMAs: no register holds a copy in flight, and
//   one __syncthreads a stage. The copies run on across tiles, so the walk over
//   tiles has no bubble.
// - Bank conflicts. Stages are row-major with rows padded to 20 floats. A
//   thread's fragment of 4 columns of one row or query is one 16-byte load; the 8
//   lanes of a quarter warp read one row (a broadcast) and 8 consecutive queries
//   (80 bytes apart: 8 distinct bank groups). So a thread's queries are tx,
//   tx + kThreadsQ, ..., and its rows four adjacent ones in each of four groups.
// - A persistent grid (as many blocks as fit on the card) walks the tiles, the
//   query tile fastest: the blocks that share a row tile run together, so at
//   B > 128 the second read of a row comes from L2.
//
// Sums are f32 in k order, one rounding per FMA: another order than a library
// GEMM's, so scores agree with the plain version to rounding, not bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace simt {

constexpr int kK = 16;       // columns of a row per pipeline stage
constexpr int kLd = kK + 4;  // floats per row of a stage: 80 bytes, conflict-free
constexpr int kStages = 3;   // stages in shared memory: two in flight while one is used

// Layout of a block for one query-tile width. A warp holds kTxLanes threads
// along the queries and 32 / kTxLanes along the rows; four neighbours along the
// rows hold 16 rows, one bucket of the bucket maxima.
template <int kQ>
struct Shape;
template <>
struct Shape<128> {
  static constexpr int kThreads = 128;
  static constexpr int kTxLanes = 8;
  static constexpr int kTN = 8;         // queries a thread holds
  static constexpr int kRowGroups = 4;  // groups of 4 adjacent rows a thread holds
  static constexpr int kMinBlocks = 2;  // blocks an SM: one's barrier under the other's FMAs
};
template <>
struct Shape<16> {
  static constexpr int kThreads = 256;
  static constexpr int kTxLanes = 4;
  static constexpr int kTN = 4;
  static constexpr int kRowGroups = 1;
  static constexpr int kMinBlocks = 2;  // three would cap a thread at 80 registers: a spill
};

template <int kQ>
struct Tile : Shape<kQ> {
  using S = Shape<kQ>;
  static constexpr int kThreadsQ = kQ / S::kTN;              // 16 | 4
  static constexpr int kThreadsR = S::kThreads / kThreadsQ;  // 8 | 64
  static constexpr int kRows = 4 * S::kRowGroups * kThreadsR;  // 128 | 256
  static constexpr int kTM = 4 * S::kRowGroups;                // rows a thread
  static constexpr int kTN = S::kTN;
  static constexpr int kWarpsQ = kThreadsQ / S::kTxLanes;      // 2 | 1
  static constexpr int kBuckets = kRows / 16;                  // buckets of a tile
  static constexpr int kStageFloats = (kRows + kQ) * kLd;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 61440 | 65280
  static_assert(kThreadsQ % S::kTxLanes == 0 && 32 / S::kTxLanes >= 4, "bucket lanes");
  static_assert(kBuckets * kQ <= kRows * kLd, "a tile's maxima fit in a row stage");
};

// Position of a thread: query c of the thread is tx + kThreadsQ c; row 4 g + i of
// the thread is 4 (kThreadsR g + ty) + i.
template <int kQ>
struct Pos {
  int lane, tx, ty;
  __device__ __forceinline__ Pos() {
    using T = Tile<kQ>;
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    tx = lane % T::kTxLanes + T::kTxLanes * (warp % T::kWarpsQ);
    ty = lane / T::kTxLanes + (32 / T::kTxLanes) * (warp / T::kWarpsQ);
  }
  __device__ __forceinline__ int query(int c) const { return tx + Tile<kQ>::kThreadsQ * c; }
  __device__ __forceinline__ int row(int i) const {
    return 4 * ((i >> 2) * Tile<kQ>::kThreadsR + ty) + (i & 3);
  }
};

// 16 bytes from device memory into shared memory, or 16 zero bytes where `in` is
// false; rows are read once, so the L2 fetches the 256 bytes around them.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0));
}

// Stage columns [k0, k0 + kK) of rows [base, base + kWidth) of a row-major
// [rows, d] matrix into s[kWidth][kLd]. d is a multiple of 4: a 16-byte chunk is
// wholly inside the row or wholly past it.
template <int kWidth, int kThreads>
__device__ __forceinline__ void copy_stage(float* s, const float* __restrict__ m, int rows, int d,
                                           int base, int k0) {
  constexpr int kChunks = kWidth * kK / 4;
#pragma unroll
  for (int i = 0; i < (kChunks + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (kChunks % kThreads != 0 && e >= kChunks) break;
    const int r = e >> 2, col = k0 + 4 * (e & 3);
    const bool in = base + r < rows && col < d;
    cp_async16(s + r * kLd + 4 * (e & 3), in ? m + (size_t)(base + r) * d + col : m, in);
  }
}

template <int kQ>
using Acc = float[Tile<kQ>::kTM][Tile<kQ>::kTN];

// acc += the kK columns of one stage: per 4 columns, the thread's queries once,
// then each of its rows against all of them.
template <int kQ>
__device__ __forceinline__ void stage_fma(const float* __restrict__ a, const float* __restrict__ q,
                                          const Pos<kQ>& p, Acc<kQ>& acc) {
  using T = Tile<kQ>;
#pragma unroll
  for (int kg = 0; kg < kK; kg += 4) {
    float4 qv[T::kTN];
#pragma unroll
    for (int c = 0; c < T::kTN; ++c)
      qv[c] = *reinterpret_cast<const float4*>(q + p.query(c) * kLd + kg);
#pragma unroll
    for (int i = 0; i < T::kTM; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(a + p.row(i) * kLd + kg);
#pragma unroll
      for (int c = 0; c < T::kTN; ++c) {
        float s = fmaf(av.x, qv[c].x, acc[i][c]);
        s = fmaf(av.y, qv[c].y, s);
        s = fmaf(av.z, qv[c].z, s);
        acc[i][c] = fmaf(av.w, qv[c].w, s);
      }
    }
  }
}

// Walk the block's tiles of (kRows rows x kQ queries) and call
// epilogue(acc, pos, row0, q0, scratch) after each, with every thread of the block.
// acc[i][c] = rows[row0 + pos.row(i)] . q[q0 + pos.query(c)]. scratch is the row
// stage just consumed (kRows x kLd floats): free once every thread has passed a
// barrier, until the end of the epilogue. `smem` holds Tile<kQ>::kSmemBytes.
template <int kQ, typename Epilogue>
__device__ __forceinline__ void run(const float* __restrict__ rows, const float* __restrict__ qv,
                                    int n, int d, int b, float* smem, Epilogue&& epilogue) {
  using T = Tile<kQ>;
  const Pos<kQ> p;
  const int q_tiles = (b + kQ - 1) / kQ;
  const int tiles = ((n + T::kRows - 1) / T::kRows) * q_tiles;
  const int k_steps = (d + kK - 1) / kK;
  if (static_cast<int>(blockIdx.x) >= tiles) return;

  // the copies run kStages - 1 stages ahead of the FMAs, across tiles
  int in_tile = blockIdx.x, in_k = 0, in_slot = 0;
  auto copy_next = [&]() {
    if (in_tile < tiles) {
      float* s = smem + in_slot * T::kStageFloats;
      const int row0 = (in_tile / q_tiles) * T::kRows, q0 = (in_tile % q_tiles) * kQ;
      copy_stage<T::kRows, T::kThreads>(s, rows, n, d, row0, in_k * kK);
      copy_stage<kQ, T::kThreads>(s + T::kRows * kLd, qv, b, d, q0, in_k * kK);
      if (++in_k == k_steps) in_k = 0, in_tile += gridDim.x;
    }
    asm volatile("cp.async.commit_group;\n" ::);  // empty past the last stage
    in_slot = in_slot == kStages - 1 ? 0 : in_slot + 1;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) copy_next();

  float acc[T::kTM][T::kTN];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int c = 0; c < T::kTN; ++c) acc[i][c] = 0.f;

  int tile = blockIdx.x, ks = 0, slot = 0;
  for (;;) {
    // this stage has landed, and every thread is done with the slot copied next
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    copy_next();
    float* s = smem + slot * T::kStageFloats;
    stage_fma<kQ>(s, s + T::kRows * kLd, p, acc);
    slot = slot == kStages - 1 ? 0 : slot + 1;
    if (++ks < k_steps) continue;
    epilogue(acc, p, (tile / q_tiles) * T::kRows, (tile % q_tiles) * kQ, s);
#pragma unroll
    for (int i = 0; i < T::kTM; ++i)
#pragma unroll
      for (int c = 0; c < T::kTN; ++c) acc[i][c] = 0.f;
    ks = 0;
    tile += gridDim.x;
    if (tile >= tiles) break;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Blocks of `kernel` that fit on an SM with its shared memory, times the SMs: the
// persistent grid's cap on the current device. Raises the kernel's dynamic shared
// memory limit there first (an attribute of each device: the callers keep the cap,
// and so this call, per device; per_device.cuh).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem_bytes, int* cap) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  if (err == cudaSuccess) *cap = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

// Grid of a launch: one block per tile, at most the resident blocks.
template <int kQ>
int grid_size(int n, int b, int cap) {
  const long long tiles =
      (long long)((n + Tile<kQ>::kRows - 1) / Tile<kQ>::kRows) * ((b + kQ - 1) / kQ);
  return static_cast<int>(tiles < cap ? tiles : cap);
}

}  // namespace simt
