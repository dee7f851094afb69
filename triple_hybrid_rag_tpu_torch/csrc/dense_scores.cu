// Dense scores f32[B, N] = q . e with f32 sums (Hopper, sm_90a).
//
// Replaces the TPU kernel `dense_scores_pallas`
// (triple_hybrid_rag_tpu/ops/pallas/dense_kernel.py): queries cast to the row
// dtype, a (B, D) x (D, N) product, every score written out. No engine path
// calls it in either package (the fused kernel of fused_topk.cu never writes
// the score matrix); it is a public function of ops/dense_kernel.py.
//
// What bounds it on an H100 at N = 1,000,448, D = 1024, B = 128 with bf16
// rows: bytes. 2.05 GB of rows read and 0.51 GB of scores written take 0.76 ms
// at 3.35 TB/s, the 268 GFLOP take 0.27 ms at 989 TFLOP/s. So the design spends
// no thread instruction on moving operands and keeps the stores out of the loads'
// way (csrc/wgmma_common.cuh):
//
// - One persistent block per SM walks output tiles of 128 queries x 256 corpus
//   rows in a static round-robin. One thread of the producer warpgroup copies
//   128 bytes of every row of both tiles per stage with TMA (128-byte swizzle)
//   into a ring of four 48 KB stages; it runs ahead into the next tile while the
//   consumers store, so one tile's stores overlap the next tile's loads. The
//   queries (256 KB in all) come back from L2.
// - Two consumer warpgroups issue wgmma m64n256k16 (bf16 -> f32) from shared
//   memory; each owns 64 queries of the tile. `setmaxnreg` gives them the
//   producer's registers for their 128 accumulators.
// - Orientation: the queries are the 64-row M operand and the corpus rows the N
//   operand, because of the store. A thread's accumulator pairs are then two
//   adjacent corpus rows of one query, 8 contiguous bytes of out[b, :], and the
//   four lanes of a quad write one full 32-byte sector: no transpose through
//   shared memory. With the corpus rows as M the tile would have to be
//   transposed first. The 8-byte stores need an even N; an odd N takes scalar
//   stores. Rows >= N and queries >= B are zero-filled by TMA and masked in the
//   store.
//
// Sums are f32 in wgmma's order, another than mma.sync's or a library GEMM's:
// scores agree with the plain version to rounding (1e-4 on unit rows), not bit
// for bit.
//
// f32 rows (embedding_dtype "float32", which the reference stores unrounded):
// `dense_scores_f32_kernel` on csrc/simt_f32.cuh, full f32 FMAs. What bounds it
// at B = 128 is the FMA issue rate (3.91 ms at 67 TFLOP/s against 1.38 ms of
// bytes); at B = 1 the 4.1 GB of rows (1.22 ms). Tiles of 128 rows x 128 queries
// (16 x 8 sums a thread) or, for B <= 16, 256 rows x 16 queries (4 x 4); the caller picks
// the width (`q_tile`). Each thread stores its four adjacent rows of one query as
// one 16-byte piece of out[b, :] (scalar stores where N is not a multiple of 4).
//
// Interface: plain C, bound with ctypes. Every function launches on the given
// stream and returns 0, a cudaError_t (cudaGetLastError() after the launch), or
// hopper::kEncodeFailed plus the encoder's CUresult when a tensor map was refused.

#include "per_device.cuh"
#include "simt_f32.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kTileQueries = 128;  // two consumer warpgroups of 64
constexpr int kTileRows = 256;     // corpus rows: the N of one wgmma
constexpr int kStages = 4;
constexpr int kBf16Threads = 384;  // producer warpgroup + two consumer warpgroups
using Pipe = hopper::Pipeline<kStages, kTileQueries, kTileRows, 8>;  // 8 consumer warps
constexpr int kBf16Smem = sizeof(Pipe) + 1024;  // room to align the ring to 1024 bytes

__global__ void __launch_bounds__(kBf16Threads, 1)
dense_scores_bf16_kernel(const __grid_constant__ CUtensorMap map_q,     // [b, d] bf16
                         const __grid_constant__ CUtensorMap map_rows,  // [n, d] bf16
                         float* __restrict__ out,                       // [b, n]
                         int n, int b, int k_blocks) {
  extern __shared__ uint8_t smem_raw[];
  Pipe& pipe = *reinterpret_cast<Pipe*>(
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023));
  if (threadIdx.x == 0) pipe.init();
  __syncthreads();

  const int q_tiles = (b + kTileQueries - 1) / kTileQueries;
  const int n_tiles = ((n + kTileRows - 1) / kTileRows) * q_tiles;
  const int wg = threadIdx.x >> 7;
  hopper::Ring<kStages> ring;

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, across tile boundaries
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int q0 = (tile % q_tiles) * kTileQueries, row0 = (tile / q_tiles) * kTileRows;
        pipe.produce(ring, k_blocks, [&](int kb, uint8_t* a, uint8_t* b, uint64_t* bar) {
          hopper::tma_load_2d(a, &map_q, kb * hopper::kStageRowBytes, q0, bar);
          hopper::tma_load_2d(b, &map_rows, kb * hopper::kStageRowBytes, row0, bar);
        });
      }
    }
  } else {
    // ---- consumers: 64 queries x 256 rows each
    hopper::reg_alloc<232>();
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x >> 5) & 3;
    const bool pairs = (n & 1) == 0;  // 8-byte stores stay aligned in every score row
    float acc[128];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      pipe.consume<hopper::WgmmaBf16N256>(ring, (wg - 1) * 64, k_blocks, acc,
                                          [](int, const uint8_t* b) { return b; });
      const int q_lo = (tile % q_tiles) * kTileQueries + (wg - 1) * 64 + warp * 16 + (lane >> 2);
      const int col0 = (tile / q_tiles) * kTileRows + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qi = q_lo + 8 * half;
        if (qi >= b) continue;
        float* dst = out + (size_t)qi * n;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = col0 + 8 * j;
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          if (pairs && col + 1 < n) {
            __stcs(reinterpret_cast<float2*>(dst + col), make_float2(v0, v1));
          } else {
            if (col < n) __stcs(dst + col, v0);
            if (col + 1 < n) __stcs(dst + col + 1, v1);
          }
        }
      }
    }
  }
}

template <int kQ>
__global__ void __launch_bounds__(simt::Shape<kQ>::kThreads, simt::Shape<kQ>::kMinBlocks)
dense_scores_f32_kernel(const float* __restrict__ emb, const float* __restrict__ qv,
                        float* __restrict__ out, int n, int d, int b) {
  using T = simt::Tile<kQ>;
  extern __shared__ float4 f32_smem[];
  const bool vec = (n & 3) == 0;  // 16-byte stores stay aligned in every score row
  simt::run<kQ>(emb, qv, n, d, b, reinterpret_cast<float*>(f32_smem),
                [&](auto& acc, const auto& p, int row0, int q0, float*) {
#pragma unroll
    for (int c = 0; c < T::kTN; ++c) {
      const int q = q0 + p.query(c);
      if (q >= b) continue;
      float* dst = out + (size_t)q * n;
#pragma unroll
      for (int g = 0; g < T::kRowGroups; ++g) {
        const int r = row0 + p.row(4 * g);
        const float4 v = make_float4(acc[4 * g][c], acc[4 * g + 1][c], acc[4 * g + 2][c],
                                     acc[4 * g + 3][c]);
        if (vec && r < n) {
          __stcs(reinterpret_cast<float4*>(dst + r), v);
        } else {
          if (r < n) __stcs(dst + r, v.x);
          if (r + 1 < n) __stcs(dst + r + 1, v.y);
          if (r + 2 < n) __stcs(dst + r + 2, v.z);
          if (r + 3 < n) __stcs(dst + r + 3, v.w);
        }
      }
    }
  });
}

template <int kQ>
int launch_dense_f32(const void* emb, const void* q, void* out, int n, int d, int b,
                     cudaStream_t stream) {
  using T = simt::Tile<kQ>;
  static int caps[per_device::kMaxDevices] = {};  // resident blocks of this width, per device
  int dev = 0;
  cudaError_t err = per_device::current(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int& cap = caps[dev];
  if (cap == 0) {
    err = simt::resident_blocks(dense_scores_f32_kernel<kQ>, T::kThreads, T::kSmemBytes, &cap);
    if (err != cudaSuccess) {
      cap = 0;
      return static_cast<int>(err);
    }
  }
  dense_scores_f32_kernel<kQ><<<simt::grid_size<kQ>(n, b, cap), T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const float*>(emb), static_cast<const float*>(q), static_cast<float*>(out),
      n, d, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dense_scores_bf16(const void* emb, const void* q, void* out, int n, int d, int b,
                      void* stream) {
  static int sm_counts[per_device::kMaxDevices] = {};
  int dev = 0;
  if (const cudaError_t e = per_device::current(&dev); e != cudaSuccess) return static_cast<int>(e);
  int& sm_count = sm_counts[dev];
  if (sm_count == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dense_scores_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16Smem);
    if (err != cudaSuccess) {
      sm_count = 0;
      return static_cast<int>(err);
    }
  }
  CUtensorMap map_q, map_rows;
  const int row_bytes = d * 2;
  int err = hopper::make_tensor_map(&map_q, q, b, row_bytes, row_bytes, kTileQueries);
  if (err == 0) err = hopper::make_tensor_map(&map_rows, emb, n, row_bytes, row_bytes, kTileRows);
  if (err != 0) return err;
  const int q_tiles = (b + kTileQueries - 1) / kTileQueries;
  const long long n_tiles = (long long)((n + kTileRows - 1) / kTileRows) * q_tiles;
  const int grid = static_cast<int>(n_tiles < sm_count ? n_tiles : sm_count);
  dense_scores_bf16_kernel<<<grid, kBf16Threads, kBf16Smem, static_cast<cudaStream_t>(stream)>>>(
      map_q, map_rows, static_cast<float*>(out), n, b,
      (row_bytes + hopper::kStageRowBytes - 1) / hopper::kStageRowBytes);
  return static_cast<int>(cudaGetLastError());
}

// f32 rows [n, d] (d a multiple of 4), f32 queries [b, d]; q_tile (16 or 128) is
// the query-tile width, which the caller picks from b
int dense_scores_f32(const void* emb, const void* q, void* out, int n, int d, int b, int q_tile,
                     void* stream) {
  if (n <= 0 || b <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_tile == 16) return launch_dense_f32<16>(emb, q, out, n, d, b, s);
  if (q_tile == 128) return launch_dense_f32<128>(emb, q, out, n, d, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
