// P1: row gather, out[i] = table[idx[i]] for a (T, 2) f32 table.
//
// Replaces scripts/probe_pallas_gather.py::_pallas_gather (pallas_call at
// line 80), the probe of whether a hand-written kernel moves random hash-table
// rows faster than the compiler's gather. The TPU kernel prefetched the
// indices, issued one DMA per row into VMEM, 2048 rows per grid step, and so
// needed N to be a multiple of 2048. Here one thread owns one row: it reads
// its index, makes one 8-byte float2 load of the row through the read-only
// path (__ldg) and writes one float2, so any N is taken, 0 included.
//
// What bounds it on an H100: bytes. Each row costs a 4-byte index read and an
// 8-byte write, both coalesced, and one 32-byte sector of the table for its 8
// useful bytes. A table that fits the 50 MB L2 (the flagship's 48.8 MB) is
// served mostly from L2 once warm; the probe's 96 MB table is not.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float2* __restrict__ table, const int32_t* __restrict__ idx,
                  float2* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = __ldg(table + __ldg(idx + i));
}

}  // namespace

// table: (T, 2) f32; idx: (n,) int32, each in [0, T) (not checked here);
// out: (n, 2) f32. Returns a cudaError_t.
extern "C" int umhs_row_gather(const float* table, const int32_t* idx, float* out, int64_t n,
                               void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  row_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(table), idx, reinterpret_cast<float2*>(out), n);
  return cudaGetLastError();
}
