// Tile loop of the bf16 bucket maxima (fused_topk.cu). The int8 and packed-int4
// bucket maxima and the bf16 dense scores run on csrc/wgmma_common.cuh, the
// float32 bodies of fused_topk.cu and dense_scores.cu on csrc/simt_f32.cuh.
//
// bf16: one block owns 128 corpus rows x 128 queries and walks the row width in
// stages of 64 bytes per row: cp.async copies the stage of the rows and of the
// queries into shared memory (two stages in flight), and the warps feed
// mma.sync.m16n8k16 from it. A k-step is 32 bytes of a row: register 0/1 hold
// bytes 4t..4t+3 of rows g and g+8, register 2/3 the same rows 16 bytes further
// on. Lane (g, t) holds rows g and g+8 for queries 2t and 2t+1 of each n8 tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tile {

constexpr int BM = 128;        // corpus rows per block
constexpr int BN = 128;        // queries per block
constexpr int KB = 64;         // bytes of a row per pipeline stage
constexpr int LDB = KB + 16;   // padded smem row (80 bytes): conflict-free fragment loads
constexpr int kThreads = 256;  // 8 warps: 4 along rows x 2 along queries

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

// c += a . b for an m16n8k16 tile, bf16 x bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Smem {
  uint8_t a[2][BM][LDB];  // row stages
  uint8_t q[2][BN][LDB];  // query stages
};

// Position of a thread in the block's 128 x 128 tile.
struct Lane {
  int warp_m, warp_n, g, t;
  __device__ __forceinline__ Lane() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    warp_m = warp & 3;   // 32 rows each
    warp_n = warp >> 2;  // 64 queries each
    g = lane >> 2;
    t = lane & 3;
  }
};

// acc[i][j][v] = sum over the row width of rows[row0 + ...] . qv[q0 + ...] for
// the thread's 2 m16 tiles x 8 n8 tiles. `row_bytes` is the width of a row and
// of a query in bytes, a multiple of 16; rows >= n and queries >= b read as 0.
__device__ __forceinline__ void mainloop(const uint8_t* __restrict__ rows,
                                         const uint8_t* __restrict__ qv, int n, int row_bytes,
                                         int b, int row0, int q0, Smem& sm, const Lane& ln,
                                         float (&acc)[2][8][4]) {
  const int tid = threadIdx.x;
  // each stage: 128 rows x 4 chunks of 16 bytes, for rows and for queries
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int c = tid + i * kThreads;  // 0..511
      int r = c >> 2;
      int col = k0 + (c & 3) * 16;
      bool in_k = col < row_bytes;
      int gr = row0 + r;
      bool pa = in_k && gr < n;
      cp_async16(&sm.a[stage][r][(c & 3) * 16], pa ? rows + (size_t)gr * row_bytes + col : rows, pa);
      int gq = q0 + r;
      bool pq = in_k && gq < b;
      cp_async16(&sm.q[stage][r][(c & 3) * 16], pq ? qv + (size_t)gq * row_bytes + col : qv, pq);
    }
  };

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

  const int kt_n = (row_bytes + KB - 1) / KB;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    if (kt + 1 < kt_n) {
      load_stage((kt + 1) & 1, (kt + 1) * KB);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = kt & 1;
#pragma unroll
    for (int kk = 0; kk < KB; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int r = ln.warp_m * 32 + i * 16 + ln.g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r][kk + 4 * ln.t]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r + 8][kk + 4 * ln.t]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r][kk + 4 * ln.t + 16]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&sm.a[st][r + 8][kk + 4 * ln.t + 16]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int qn = ln.warp_n * 64 + j * 8 + ln.g;
        uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sm.q[st][qn][kk + 4 * ln.t]);
        uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sm.q[st][qn][kk + 4 * ln.t + 16]);
        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);
      }
    }
    __syncthreads();
  }
}

}  // namespace tile
