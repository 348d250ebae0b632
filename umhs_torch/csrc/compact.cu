// K6a and K6b: the compact path's compaction and its lane <-> slot gathers.
//
// Replaces the staged compact loop of umhs_tpu/models/model.py (XLA on the
// TPU): the slot map and the `src` scatter at lines 440-454 (K6a), the
// densities gathered back through the slot map at line 483 and the weights
// gathered through `src` at lines 520-525 (K6b). In the original system
// nerfacc's CUDA kernels did this work (pack_info and the packed layout).
//
// For one stage (lanes [lo, hi) of every ray, L = hi - lo) with a budget of
// Bs rows, over the (R, L) mask m (already and-ed with the rays still alive):
// - slot[r, l] = the exclusive scan of m over the flattened (R, L);
// - kept[r, l] = m[r, l] && slot[r, l] < Bs (the overflow is dropped);
// - src[b] = the flat lane that holds row b, for b < total; 0 past total;
// - live[b] = b < total; counts[r] = the kept lanes of ray r; starts[r] =
//   their exclusive scan; total = min(sum of m, Bs), kept on the device.
// The slot map and src invert each other on kept lanes, so each gather's
// gradient is the other gather: rows -> lanes through slot (masked by
// kept), lanes -> rows through src (rows past total give 0). Neither needs
// a sort, an atomic or a host sync, and each output element is written by
// one thread, so every run gives the same bits.
//
// What bounds it on an H100: bytes. The stage's mask is read twice (one
// byte a lane), slot, kept and src written once; the gathers read one
// float and an index per element. The three compaction passes are a warp a
// ray (a ballot gives each lane its rank in the ray), one block that scans
// the per-ray counts in tiles of 4,096 rays, and a warp a ray again; the
// scan's one block is a few microseconds at 79,360 rays, small beside the
// per-lane passes. A simple design first: the passes are not fused.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps (rays) per block in the per-ray passes
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;  // counts per thread per tile of the scan
constexpr int kThreads = 256;  // threads per block in the gathers

__device__ __forceinline__ bool lane_on(const uint8_t* mask, int64_t stride,
                                        const uint8_t* live_rays, int32_t r, int32_t l,
                                        int32_t L) {
  return l < L && (live_rays == nullptr || live_rays[r]) &&
         mask[static_cast<int64_t>(r) * stride + l] != 0;
}

// counts[r] = the lanes of ray r that are on (before the overflow drop).
__global__ void __launch_bounds__(kWarps * 32)
compact_count_kernel(const uint8_t* __restrict__ mask, int64_t stride,
                     const uint8_t* __restrict__ live_rays, int32_t R, int32_t L,
                     int64_t* __restrict__ counts) {
  const int32_t r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // uniform over the warp
  int32_t n = 0;
  for (int32_t l0 = 0; l0 < L; l0 += 32)
    n += __popc(__ballot_sync(kFull, lane_on(mask, stride, live_rays, r, l0 + lane, L)));
  if (lane == 0) counts[r] = n;
}

// starts[r] = the exclusive scan of counts (before the drop), in tiles of
// kScanThreads * kScanItems rays; total = min(sum, budget). One block.
__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(const int64_t* __restrict__ counts, int64_t* __restrict__ starts,
                    int32_t R, int32_t budget, int32_t* __restrict__ total) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  int32_t carry = 0;
  for (int64_t base = 0; base < R; base += kScanThreads * kScanItems) {
    int32_t v[kScanItems];
    int32_t sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = base + static_cast<int64_t>(t) * kScanItems + k;
      v[k] = i < R ? static_cast<int32_t>(counts[i]) : 0;
      sum += v[k];
    }
    int32_t incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[w] = incl;
    __syncthreads();
    if (w == 0) {
      int32_t s = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, s, off);
        if (lane >= off) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    int32_t excl = carry + (w > 0 ? warp_sums[w - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = base + static_cast<int64_t>(t) * kScanItems + k;
      if (i < R) starts[i] = excl;
      excl += v[k];
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is rewritten by the next tile
  }
  if (t == 0) *total = carry < budget ? carry : budget;
}

// A warp a ray: slot, kept and src for the ray's lanes, then its counts and
// starts after the drop. Every thread of the grid also fills row b = its
// global index: live[b], and src[b] = 0 past total.
__global__ void __launch_bounds__(kWarps * 32)
compact_place_kernel(const uint8_t* __restrict__ mask, int64_t stride,
                     const uint8_t* __restrict__ live_rays, int32_t R, int32_t L,
                     int32_t budget, const int32_t* __restrict__ total,
                     int64_t* __restrict__ counts, int64_t* __restrict__ starts,
                     int32_t* __restrict__ slot, uint8_t* __restrict__ kept,
                     int64_t* __restrict__ src, float* __restrict__ live) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * (kWarps * 32) + threadIdx.x;
  if (g < budget) {
    const int32_t tot = *total;
    live[g] = g < tot ? 1.0f : 0.0f;
    if (g >= tot) src[g] = 0;
  }
  const int64_t r = g >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // uniform over the warp
  const int64_t off = starts[r], c = counts[r];
  int64_t next = off;  // slot of the ray's next lane that is on
  for (int32_t l0 = 0; l0 < L; l0 += 32) {
    const int32_t l = l0 + lane;
    const bool on = lane_on(mask, stride, live_rays, static_cast<int32_t>(r), l, L);
    const unsigned ballot = __ballot_sync(kFull, on);
    const int64_t s = next + __popc(ballot & ((1u << lane) - 1u));
    if (l < L) {
      const int64_t flat = r * L + l;
      const bool keep = on && s < budget;
      slot[flat] = static_cast<int32_t>(s);
      kept[flat] = keep;
      if (keep) src[s] = flat;
    }
    next += __popc(ballot);
  }
  __syncwarp();  // every lane has read counts[r] and starts[r]
  if (lane == 0) {
    const int64_t room = budget - off;
    counts[r] = room <= 0 ? 0 : (c < room ? c : room);
    starts[r] = off < budget ? off : budget;
  }
}

// out[i] = kept[i] ? rows[slot[i]] : 0 over the n = R * L lanes.
__global__ void __launch_bounds__(kThreads)
lanes_from_rows_kernel(const float* __restrict__ rows, const int32_t* __restrict__ slot,
                       const uint8_t* __restrict__ kept, float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) out[i] = kept[i] ? rows[slot[i]] : 0.0f;
}

// out[b] = b < total ? lanes[src[b] / L, src[b] % L] : 0 over the n = Bs
// rows; lanes has row stride `stride`.
__global__ void __launch_bounds__(kThreads)
rows_from_lanes_kernel(const float* __restrict__ lanes, int64_t stride, int32_t L,
                       const int64_t* __restrict__ src, const int32_t* __restrict__ total,
                       float* __restrict__ out, int64_t n) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= n) return;
  if (b >= *total) {
    out[b] = 0.0f;
    return;
  }
  const int64_t f = src[b];
  out[b] = lanes[(f / L) * stride + f % L];
}

}  // namespace

// K6a. mask: the stage's (R, L) lanes of a bool mask with row stride
// `stride` (bytes); live_rays: (R,) bool or null; budget: Bs. Outputs:
// slot (R * L) int32, kept (R * L) bool, src (Bs) int64, live (Bs) f32,
// counts and starts (R) int64, total (1) int32. R * L and Bs below 2^31.
// Returns a cudaError_t.
extern "C" int umhs_compact_stage(const uint8_t* mask, int64_t stride, const uint8_t* live_rays,
                                  int32_t R, int32_t L, int32_t budget, int32_t* slot,
                                  uint8_t* kept, int64_t* src, float* live, int64_t* counts,
                                  int64_t* starts, int32_t* total, void* stream) {
  if (R < 0 || L < 1 || budget < 1 || stride < L) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t ray_blocks = (static_cast<int64_t>(R) + kWarps - 1) / kWarps;
  const int64_t threads = static_cast<int64_t>(R) * 32 > budget ? static_cast<int64_t>(R) * 32
                                                                 : budget;
  if (R > 0) {
    compact_count_kernel<<<static_cast<unsigned>(ray_blocks), kWarps * 32, 0, s>>>(
        mask, stride, live_rays, R, L, counts);
  }
  compact_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, starts, R, budget, total);
  compact_place_kernel<<<static_cast<unsigned>((threads + kWarps * 32 - 1) / (kWarps * 32)),
                         kWarps * 32, 0, s>>>(mask, stride, live_rays, R, L, budget, total,
                                              counts, starts, slot, kept, src, live);
  return cudaGetLastError();
}

// K6b. to_rows = 0: lanes (R * L) f32 from rows (Bs) f32 through slot and
// kept (K6a's); to_rows = 1: rows (Bs) f32 from lanes (R, L) f32 of row
// stride `stride` through src and total. n is R * L or Bs. Returns a
// cudaError_t.
extern "C" int umhs_compact_gather(int to_rows, const float* in, int64_t stride, int32_t L,
                                   const int32_t* slot, const uint8_t* kept, const int64_t* src,
                                   const int32_t* total, float* out, int64_t n, void* stream) {
  if (n < 0 || L < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (to_rows)
    rows_from_lanes_kernel<<<blocks, kThreads, 0, s>>>(in, stride, L, src, total, out, n);
  else
    lanes_from_rows_kernel<<<blocks, kThreads, 0, s>>>(in, slot, kept, out, n);
  return cudaGetLastError();
}
