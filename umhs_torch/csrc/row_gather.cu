// P1: row gather, out[i] = table[idx[i]] for a (T, 2) f32 table.
//
// Replaces scripts/probe_pallas_gather.py::_pallas_gather (pallas_call at
// line 80), the probe of whether a hand-written kernel moves random hash-table
// rows faster than the compiler's gather. The TPU kernel prefetched the
// indices, issued one DMA per row into VMEM, 2048 rows per grid step, and so
// needed N to be a multiple of 2048. Here any N is taken, 0 included.
//
// What bounds it on an H100: the table's random reads. The streams are
// coalesced (a 4-byte index read and an 8-byte row written per row), but
// each row costs one 32-byte sector of the table for 8 useful bytes, and a
// table larger than the share of the 50 MB L2 that random reads from every
// SM can use (about 20 MB, measured) goes to DRAM at random. One thread per
// row, or several rows per thread with their loads in flight together, all
// run at that rate: more reads in flight did not help.
//
// The design walks the table in slices. A block owns a wave of
// kThreads * kRows rows: it reads their indices once (streaming, evict-first)
// into registers, then, for each slice of the table in turn, gathers only
// the rows whose index falls in that slice into shared memory, and at the end
// writes the wave's rows out (streaming, coalesced). Every block is resident
// at once and walks the slices in the same order, so at any moment the
// card's reads fall in one slice of slice_rows rows, which the L2 holds;
// successive waves walk the slices in alternate directions, so that the
// slice at a wave's end is the one the next wave starts in. The caller picks
// slice_rows (8 MB of table per slice, at most 6 slices; one slice for a
// table that fits) and the grid (one block per wave, at most the blocks
// resident at once, umhs_row_gather_blocks_per_sm). Each row is read and
// written once, in any order across blocks, so the output is table[idx] bit
// for bit. Measured against other shapes on an H100 (PERF.md, P1): 128-thread
// blocks of 14 rows a thread (48 registers, 10 blocks resident per SM) ran
// faster than the same walk in 256-thread blocks; on the 96 MB table 6
// slices ran faster than 1, 3 or 12, on the 48.8 MB table 3 and 6 tied.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kRows = 14;      // rows per thread in a wave
constexpr int kWave = kThreads * kRows;

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float2* __restrict__ table, const int32_t* __restrict__ idx,
                  float2* __restrict__ out, int64_t n, int32_t slices, int32_t slice_rows) {
  __shared__ float2 rows[kWave];
  const int t = threadIdx.x;
  int wave = 0;
  for (int64_t w0 = static_cast<int64_t>(blockIdx.x) * kWave; w0 < n;
       w0 += static_cast<int64_t>(gridDim.x) * kWave, ++wave) {
    int32_t r[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t i = w0 + k * kThreads + t;
      r[k] = i < n ? __ldcs(idx + i) : -1;  // -1 falls in no slice
    }
    for (int32_t s = 0; s < slices; ++s) {
      const int32_t lo = ((wave & 1) ? slices - 1 - s : s) * slice_rows;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (static_cast<uint32_t>(r[k] - lo) < static_cast<uint32_t>(slice_rows))
          rows[k * kThreads + t] = __ldg(table + r[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t i = w0 + k * kThreads + t;
      if (i < n) __stcs(out + i, rows[k * kThreads + t]);
    }
  }
}

}  // namespace

// The blocks of row_gather_kernel resident on one SM at once. Returns a
// cudaError_t.
extern "C" int umhs_row_gather_blocks_per_sm(int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, row_gather_kernel, kThreads, 0);
}

// table: (table_rows, 2) f32; idx: (n,) int32, each in [0, table_rows) (not
// checked here); out: (n, 2) f32. The table is walked in slices of
// slice_rows rows, by `blocks` blocks (umhs_torch/ops/row_gather.py:
// row_gather_slices and row_gather_grid). Returns a cudaError_t.
extern "C" int umhs_row_gather(const float* table, const int32_t* idx, float* out, int64_t n,
                               int32_t table_rows, int32_t slice_rows, int32_t blocks,
                               void* stream) {
  if (n < 0 || table_rows < 1 || slice_rows < 1 || blocks < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int32_t slices = (table_rows - 1) / slice_rows + 1;
  row_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(table), idx, reinterpret_cast<float2*>(out), n, slices,
      slice_rows);
  return cudaGetLastError();
}
