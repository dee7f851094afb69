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
// at 3.35 TB/s, the 268 GFLOP take 0.27 ms at 989 TFLOP/s. Design: the tile
// loop of the fused kernel (csrc/tile_common.cuh; 128 rows x 128 queries per
// block, each row read once) with a store epilogue. Lane (g, t) holds rows g
// and g+8 for queries 2t and 2t+1 of each n8 tile, so the eight lanes of one t
// write eight adjacent f32 of one query's score row: a full 32-byte sector.
//
// The float32 variant keeps full f32 products (plain FMAs) in a 64 x 64 tile.
//
// Interface: plain C, bound with ctypes. Every function launches on the given
// stream and returns cudaGetLastError() as an int.

#include "tile_common.cuh"

namespace {

using namespace tile;

__global__ void __launch_bounds__(kThreads, 2)
dense_scores_bf16_kernel(const uint8_t* __restrict__ emb,  // [n, d] bf16
                         const uint8_t* __restrict__ qv,   // [b, d] bf16
                         float* __restrict__ out,          // [b, n]
                         int n, int row_bytes, int b) {
  __shared__ __align__(16) Smem sm;
  const Lane ln;
  const int row0 = blockIdx.x * BM;
  const int q0 = blockIdx.y * BN;
  float acc[2][8][4];
  mainloop<MmaBf16>(emb, qv, n, row_bytes, b, row0, q0, sm, ln, acc);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r_lo = row0 + ln.warp_m * 32 + i * 16 + ln.g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int qa = q0 + ln.warp_n * 64 + j * 8 + 2 * ln.t;
      const int qb = qa + 1;
      if (qa < b) {
        if (r_lo < n) out[(size_t)qa * n + r_lo] = acc[i][j][0];
        if (r_hi < n) out[(size_t)qa * n + r_hi] = acc[i][j][2];
      }
      if (qb < b) {
        if (r_lo < n) out[(size_t)qb * n + r_lo] = acc[i][j][1];
        if (r_hi < n) out[(size_t)qb * n + r_hi] = acc[i][j][3];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreadsF32)
dense_scores_f32_kernel(const float* __restrict__ emb, const float* __restrict__ qv,
                        float* __restrict__ out, int n, int d, int b) {
  __shared__ SmemF32 sm;
  const int tx = threadIdx.x & 15;  // queries tx*4 .. tx*4+3
  const int ty = threadIdx.x >> 4;  // rows ty*4 .. ty*4+3
  const int row0 = blockIdx.x * FM;
  const int q0 = blockIdx.y * FN;
  float acc[4][4];
  mainloop_f32(emb, qv, n, d, b, row0, q0, sm, acc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = q0 + tx * 4 + j;
    if (q >= b) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < n) out[(size_t)q * n + r] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

int dense_scores_bf16(const void* emb, const void* q, void* out, int n, int d, int b,
                      void* stream) {
  dim3 grid((n + BM - 1) / BM, (b + BN - 1) / BN);
  dense_scores_bf16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(emb), static_cast<const uint8_t*>(q),
      static_cast<float*>(out), n, d * 2, b);
  return static_cast<int>(cudaGetLastError());
}

int dense_scores_f32(const void* emb, const void* q, void* out, int n, int d, int b,
                     void* stream) {
  dim3 grid((n + FM - 1) / FM, (b + FN - 1) / FN);
  dense_scores_f32_kernel<<<grid, kThreadsF32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const float*>(q), static_cast<float*>(out),
      n, d, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
