// The mma.sync product of the MaxSim kernel (maxsim.cu), which gives each warp a
// pipeline of its own over tiles too small for a 64-row wgmma.
//
// The bf16 bucket maxima no longer run here. Their old loop (a block per 128 rows x
// 128 queries, two cp.async stages of 64 bytes a row, operands moved into registers
// by every thread for mma.sync) reached half of the 2.05 GB row read's time at the
// serving shape; the TMA + wgmma pipeline of wgmma_common.cuh replaces it
// (fused_topk.cu: one persistent block per SM, a four-stage TMA ring, two consumer
// warpgroups, a branch-free epilogue in registers).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

// c += a . b for an m16n8k16 tile, bf16 x bf16 -> f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tile
