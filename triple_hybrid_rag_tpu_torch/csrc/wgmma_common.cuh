// Hopper main loop shared by the dense-channel kernels (dense_scores.cu, the int8
// and packed-int4 bodies of fused_topk.cu): TMA loads into a ring of shared-memory
// stages, guarded by full/empty mbarriers, feeding wgmma.
//
// Everything is written in BYTES. Both operands are K-major matrices in device
// memory (a row is contiguous along the reduction axis), as the corpus rows
// [N, D] and the queries [B, D] are, in bf16, int8 or packed nibbles. A stage
// holds 128 bytes of each row of an operand tile: 64 bf16 values, 128 int8 values
// or 128 packed bytes. TMA writes it with the 128-byte swizzle, which is the
// layout the wgmma shared-memory descriptor names: rows 128 bytes apart, groups
// of 8 rows 1024 bytes apart, the 16-byte chunks of a row XOR-ed with the row's
// index modulo 8. A tile therefore starts on a 1024-byte boundary, and a k-step of
// wgmma (32 bytes of a row for every operand type: 16 bf16 or 32 int8 values)
// moves the descriptor's start address by 32 bytes inside the swizzled row.
//
// What a kernel chooses: the rows of the A and B tiles in a stage (B may be
// absent from the ring when it stays resident elsewhere in shared memory), how
// many warps consume a stage, and the wgmma: `WgmmaBf16N256` (bf16 -> f32,
// m64n256k16) or `WgmmaS8N128` (s8 -> s32, m64n128k32, A from shared memory or
// from registers; the integer wgmma takes K-major operands only, which both
// matrices are).
//
// One elected thread of the producer warpgroup starts every copy; the consumer
// warpgroups never compute an address of an operand that wgmma reads from shared
// memory. `setmaxnreg` hands the producer's registers to the consumers. Every
// consumer of a ring consumes every stage of it: consumers that take different
// output tiles get a ring (and a producer thread) each, because one that skipped
// the others' stages could fall a lap behind, and a parity wait cannot tell laps
// apart.
//
// Needs sm_90a. Nothing here launches a kernel; `make_tensor_map` is host code
// and fetches cuTensorMapEncodeTiled from libcuda at run time, so no library is
// linked.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kStageRowBytes = 128;      // bytes of a row per stage: the swizzle span
constexpr int kMmaKBytes = 32;           // bytes of a row per wgmma k-step
constexpr int kEncodeFailed = 100000;    // added to a CUresult of the tensor-map encoder

// ------------------------------------------------------------------ host side

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                     CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched from libcuda once. Returns 0 or a cudaError_t.
inline int tensor_map_encoder(TensorMapEncode* out) {
  static TensorMapEncode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<TensorMapEncode>(fn);
  }
  *out = encode;
  return 0;
}

// Tensor map of a K-major matrix of `rows` rows, `row_bytes` wide and `pitch_bytes`
// apart (a multiple of 16, base 16-byte aligned), cut into boxes of `box_rows` rows
// x 128 bytes with the 128-byte swizzle. Rows and bytes outside the matrix read as
// zero, so a map narrower than the pitch describes a band of columns whose ragged
// last stage does not run into the next band. Returns 0, a cudaError_t, or
// kEncodeFailed + the encoder's CUresult.
inline int make_tensor_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t row_bytes,
                           uint64_t pitch_bytes, uint32_t box_rows) {
  TensorMapEncode encode;
  const int err = tensor_map_encoder(&encode);
  if (err != 0) return err;
  const cuuint64_t dims[2] = {row_bytes, rows};  // innermost first
  const cuuint64_t strides[1] = {pitch_bytes};   // bytes between rows
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStageRowBytes), box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

// ---------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(arrivals)
               : "memory");
}

// after the inits of one thread, before any other thread or the TMA uses a barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the tensor map, at (byte c0 of row c1), into shared memory; the copy
// reports its bytes to `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// Position in a ring of kStages stages, with the phase bit of the stage's
// barriers. A consumer starts at parity 0 (waits for the first fill); a producer
// waits on `parity ^ 1`, which passes at once on a stage never used.
template <int kStages>
struct Ring {
  int stage = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      parity ^= 1;
    }
  }
};

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major tile written with the 128-byte swizzle, starting
// at `tile` (1024-byte aligned) plus `k_bytes` along the row (a multiple of 32)
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, int k_bytes) {
  uint64_t desc = (static_cast<uint64_t>(smem_addr(tile) + k_bytes) & 0x3FFFF) >> 4;
  desc |= static_cast<uint64_t>(1) << 16;           // leading byte offset: unused with a swizzle
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;   // stride byte offset: 8 rows of 128 bytes
  desc |= static_cast<uint64_t>(1) << 62;           // 128-byte swizzle
  return desc;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d[64 x 256] (+)= a[64 x 16] . b[256 x 16]^T, bf16 operands from shared memory,
// f32 sums; `accumulate` 0 overwrites d. Thread t of the warpgroup holds, for
// j = 0..31, d[4j], d[4j+1] = row 16*(t/32) + (t%32)/4, columns 8j + 2*(t%4) and
// the next; d[4j+2], d[4j+3] = the same columns 8 rows further down.
struct WgmmaBf16N256 {
  using acc_t = float;
  static constexpr int kAcc = 128;  // accumulator registers a thread
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63,"
        " %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79,"
        " %80, %81, %82, %83, %84, %85, %86, %87,"
        " %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103,"
        " %104, %105, %106, %107, %108, %109, %110, %111,"
        " %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " %128, %129, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
          "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
};

#define HOPPER_R8(d, i) \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define HOPPER_R64(d) \
  HOPPER_R8(d, 0), HOPPER_R8(d, 8), HOPPER_R8(d, 16), HOPPER_R8(d, 24), HOPPER_R8(d, 32), \
      HOPPER_R8(d, 40), HOPPER_R8(d, 48), HOPPER_R8(d, 56)
#define HOPPER_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= a[64 x 32] . b[128 x 32]^T, s8 operands, exact s32 sums;
// `accumulate` 0 overwrites d. Thread t of the warpgroup holds, for j = 0..15,
// d[4j], d[4j+1] = row 16*(t/32) + (t%32)/4, columns 8j + 2*(t%4) and the next;
// d[4j+2], d[4j+3] = the same columns 8 rows further down: a warp owns 16 rows.
struct WgmmaS8N128 {
  using acc_t = int;
  static constexpr int kAcc = 64;  // accumulator registers a thread
  // both operands from shared memory
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_D64 ", %64, %65, p;\n"
        "}\n"
        : HOPPER_R64(d)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  // A from registers, in the fragment layout of mma.m16n8k32: a[0], a[1] = bytes
  // 4*(t%4) .. +3 of the k-step for the thread's two rows (as d's), a[2], a[3] =
  // the same rows 16 bytes further on. The registers are read while the wgmma is
  // in flight: they may be written again only after wgmma_wait.
  static __device__ __forceinline__ void mma_rs(int (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " HOPPER_D64
        ", {%64, %65, %66, %67}, %68, p;\n"
        "}\n"
        : HOPPER_R64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  }
};

#undef HOPPER_R8
#undef HOPPER_R64
#undef HOPPER_D64

// ------------------------------------------------- producer / consumer main loop

// Shared memory of a ring whose stage holds 128 bytes of kRowsA rows of A and of
// kRowsB rows of B (0: B is not streamed). A stage is consumed by
// kConsumerWarps warps, each of which hands it back through lane 0.
template <int kStages, int kRowsA, int kRowsB, int kConsumerWarps>
struct Pipeline {
  static constexpr uint32_t kBytesA = kRowsA * kStageRowBytes;
  static constexpr uint32_t kStageBytes = (kRowsA + kRowsB) * kStageRowBytes;
  static_assert(kRowsA % 8 == 0 && kRowsB % 8 == 0, "tiles start on 1024-byte boundaries");
  static_assert(kStages >= 2, "a stage is handed back while the next is consumed");
  alignas(1024) uint8_t tiles[kStages][kStageBytes];
  alignas(8) uint64_t full[kStages];   // the stage's copies have landed
  alignas(8) uint64_t empty[kStages];  // every consumer warp is done with the stage

  __device__ __forceinline__ uint8_t* a(int stage) { return tiles[stage]; }
  __device__ __forceinline__ uint8_t* b(int stage) { return tiles[stage] + kBytesA; }

  // by one thread, followed by a block-wide barrier
  __device__ __forceinline__ void init() {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrive.expect_tx
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_fence_init();
  }

  // Producer thread: fills the `k_blocks` stages of one output tile, waiting for
  // each to be free. `copy(kb, a, b, bar)` starts the stage's copies, kStageBytes
  // in all, each reporting to `bar`.
  template <typename Copy>
  __device__ __forceinline__ void produce(Ring<kStages>& ring, int k_blocks, Copy copy) {
    for (int kb = 0; kb < k_blocks; ++kb) {
      mbar_wait(&empty[ring.stage], ring.parity ^ 1);
      mbar_arrive_expect_tx(&full[ring.stage], kStageBytes);
      copy(kb, a(ring.stage), b(ring.stage), &full[ring.stage]);
      ring.advance();
    }
  }

  // lane 0 of a consumer warp: the warp is done with the stage
  __device__ __forceinline__ void release(int stage) {
    if (stage >= 0 && (threadIdx.x & 31) == 0) mbar_arrive(&empty[stage]);
  }

  // Consumer warpgroup: acc = A[row_a .. row_a + 63] . B^T over the `k_blocks`
  // stages of one output tile, both operands from shared memory. `b_tile(kb, b)`
  // names the B tile of k-block kb: `b`, the stage's own, or a resident one. The
  // wgmmas of a stage stay in flight while the next stage's are started; a stage is
  // handed back when its wgmmas have completed. On return nothing is in flight
  // and acc may be read.
  template <typename Mma, typename BTile>
  __device__ __forceinline__ void consume(Ring<kStages>& ring, int row_a, int k_blocks,
                                          typename Mma::acc_t (&acc)[Mma::kAcc], BTile b_tile) {
    int prev = -1;
    for (int kb = 0; kb < k_blocks; ++kb) {
      mbar_wait(&full[ring.stage], ring.parity);
      const uint8_t* ta = a(ring.stage) + row_a * kStageRowBytes;
      const uint8_t* tb = b_tile(kb, b(ring.stage));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kStageRowBytes; k += kMmaKBytes)
        Mma::mma(acc, wgmma_desc(ta, k), wgmma_desc(tb, k), (kb | k) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas are done
      release(prev);
      prev = ring.stage;
      ring.advance();
    }
    wgmma_wait<0>();
    release(prev);
  }
};

}  // namespace hopper
