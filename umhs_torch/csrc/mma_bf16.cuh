// Tensor-core building blocks for the fused-MLP kernels: bf16 operands,
// f32 accumulation, through mma.sync (sm_80 and later; sm_90a here).
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for lane
// = 4 * gid + tig (gid = lane / 4, tig = lane % 4):
// - A (16 x 16, row-major), four bf16x2 registers: a0 = A[gid][2tig..+1],
//   a1 = A[gid + 8][2tig..+1], a2 = A[gid][2tig + 8..+9],
//   a3 = A[gid + 8][2tig + 8..+9];
// - B (16 x 8, k x n), two bf16x2 registers: b0 = B[2tig..+1][gid],
//   b1 = B[2tig + 8..+9][gid];
// - C/D (16 x 8) f32: c0 = C[gid][2tig], c1 = C[gid][2tig + 1],
//   c2 = C[gid + 8][2tig], c3 = C[gid + 8][2tig + 1].
// So the C fragments of two neighbouring n-tiles (columns 16j..16j+15) are,
// once rounded to bf16x2, the A fragment of k-tile j of the next product:
// a0 = (c0, c1) and a1 = (c2, c3) of n-tile 2j, a2 and a3 likewise of 2j + 1.
// A chain of layers can keep its activations in registers.
//
// B is kept in shared memory transposed, Bt[n][k] (k contiguous), with a row
// stride of K + 8 bf16 (K a multiple of 16): the eight 16-byte rows that one
// ldmatrix 8x8 matrix reads then fall on distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace umhs {

// (lo, hi) rounded to bf16 (round to nearest even) and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b for one m16n8k16 tile.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane i gives the address of row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// Two 8x8 bf16 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// The same two loads, each 8x8 matrix transposed on the way: lane 4 * gid +
// tig receives elements [2tig][gid] and [2tig + 1][gid] of its matrix. So a
// matrix S stored row-major as S[k][m] (m contiguous) arrives as the A or B
// fragment of S^T: the operands of a product that sums over S's rows.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// 16 bytes from global to shared memory without registers; only the first
// `src_bytes` (0-16) are read and the rest are zero-filled. Both addresses
// 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

}  // namespace umhs
