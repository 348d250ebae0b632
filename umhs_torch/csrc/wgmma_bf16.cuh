// Hopper warpgroup products (wgmma) fed by the tensor memory accelerator
// (TMA), sm_90a only, for the general route's bf16 products
// (mlp_general.cuh): m64n256k16, bf16 operands from shared memory, f32 sums
// in registers.
//
// Operand tiles are 64 k deep and 128-byte swizzled, as TMA writes them:
// - K-major (k contiguous in device memory): one TMA box of 64 k x R rows,
//   each row's 128 bytes at row * 128 with its 16-byte chunks XOR-ed by the
//   row mod 8; 8-row groups 1,024 bytes apart (SBO), a k16 step 32 bytes on;
// - MN-major (the operand's m or n contiguous, as both operands of the dW
//   product over rows are): boxes of 64 MN x 64 k, each 64 k-rows of 128
//   bytes (8 KB), one a 64-wide MN block 8,192 bytes apart (LBO), 8 k-rows
//   1,024 bytes apart (SBO), a k16 step 2,048 bytes on; the instruction's
//   transpose bit says which.
// (CUTLASS's make_gmma_desc sets LBO and SBO so for these canonical
// layouts.) Each tile starts on a 1,024-byte boundary, so the descriptor's
// base offset is 0.
//
// Accumulator layout (m64nNk16, per warpgroup of 128 threads): thread t =
// 32 w + lane holds rows 16 w + lane / 4 (+ 8) and columns 8 j + 2 (lane %
// 4) (+ 1): d[4 j + e] at row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2
// (lane % 4) + e % 2, the mma.sync m16n8 C fragment repeated over n-tiles.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace umhs {
namespace wg {

// The matrix descriptor of a 128-byte-swizzled tile at `p` (shared memory):
// lbo, sbo in bytes, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}

#define UMHS_WG_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define UMHS_WG_D64(i)                                                                       \
  UMHS_WG_D8(i), UMHS_WG_D8(i + 8), UMHS_WG_D8(i + 16), UMHS_WG_D8(i + 24), UMHS_WG_D8(i + 32), \
      UMHS_WG_D8(i + 40), UMHS_WG_D8(i + 48), UMHS_WG_D8(i + 56)

// d (64 x 256, this warpgroup's) += A (64 x 16) . B (16 x 256); kTA / kTB:
// the operand is MN-major (the transpose bit).
template <int kTA, int kTB>
__device__ __forceinline__ void mma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : UMHS_WG_D64(0), UMHS_WG_D64(64)
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB)
      : "memory");
}

#undef UMHS_WG_D64
#undef UMHS_WG_D8

// ---------------------------------------------------- mbarriers and TMA

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// This thread's arrival, and `bytes` more the barrier waits for from TMA.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Waits until the barrier's phase of `parity` has completed. A wait past
// ~10 s of clock (a TMA that never lands) traps, so a fault fails the
// launch instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// A 2-D box of the tensor map at (c0 inner, c1 outer) into shared memory,
// its bytes reported to `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no link
// to libcuda); null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a bf16 matrix of `outer` rows of `inner` elements (row
// stride ld elements, a multiple of 8), boxes of box_inner x box_outer,
// 128-byte swizzle, zeros past the edges.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int64_t inner, int64_t outer,
                              int64_t ld, uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace umhs
