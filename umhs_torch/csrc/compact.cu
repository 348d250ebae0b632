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
// What bounds it on an H100: bytes. K6a reads the stage's mask once (one
// byte a lane) and writes slot, kept, src, live, counts and starts once;
// the gathers read one float and an index per element.
//
// K6a is one launch a stage: a single-pass scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA, 2016) over tiles of whole rays, at most 4,096 lanes a
// tile, where such a tile holds a multiple of 16 lanes (every L up to 256,
// and longer L whose multiples reach one). A block takes its tile from an
// atomic ticket, so the tiles start in order and a block that waits on a
// predecessor knows it is running. Each thread reads 16 consecutive lanes
// of the tile in vector loads (16, 8 or 4 bytes where the column slice
// allows, so no lane of a warp idles at L = 8), keeps them as 16 bits, and
// the block scans the threads' counts. The block publishes its aggregate,
// a warp looks back over the predecessors' flags, and the block publishes
// its inclusive prefix, each flag one 64-bit word (epoch, status, value) in
// one store. From the same registers it writes slot, kept and src, then
// each ray's counts and starts after the drop. The blocks with the last
// tickets wait for the last tile's prefix and write `live` and the rows
// past the total, so the stage is one launch.
// Where no whole-ray tile fits (L 257, 4,097), the tiles are 4,096 lanes
// of the flattened (R, L) that rays cross, and a second, small launch
// follows. A ray's starts and counts follow from the scan at its first
// lane and past its last: starts[r] = min(excl(first), Bs), counts[r] =
// min(excl(first of r + 1), Bs) - starts[r] (the total for the last ray).
// The tile holding the first lane writes starts; a ray's two ends may lie
// in different tiles, so the second launch takes the counts as the
// differences of consecutive starts.
// The flags live in a workspace the wrapper allocates once per device and
// stream and never clears per call: a flag counts only with the launch's
// epoch, a number the wrapper hands in and steps by one each call (it
// clears the workspace once when the epoch wraps). The last block to take a
// ticket sets the ticket back to 0 for the next launch.
// An epoch handed in by value would repeat under a replayed CUDA graph; a
// graph would need it on the device.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;        // threads per block in every kernel here
constexpr int kLanesPerThread = 16;  // K6a: consecutive lanes a thread
constexpr int kTileLanes = kThreads * kLanesPerThread;  // K6a: lanes a tile at most
constexpr int kFillRows = 8;         // K6a: rows a thread in a fill block
constexpr uint32_t kAggregate = 1, kInclusive = 2;  // a flag's status

struct StageArgs {
  const uint8_t* mask;
  int64_t stride;
  const uint8_t* live_rays;
  int32_t R, L, budget, tile_rays, vec_bytes, n_tiles;  // tile_rays 0: flat tiles
  uint32_t epoch;
  unsigned long long* flags;  // one a tile
  unsigned int* ticket;
  int32_t* slot;
  uint8_t* kept;
  int64_t* src;
  float* live;
  int64_t* counts;
  int64_t* starts;
  int32_t* total;
};

__device__ __forceinline__ unsigned long long load_flag(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_flag(unsigned long long* p, uint32_t epoch,
                                           uint32_t status, int32_t value) {
  const unsigned long long v =
      (static_cast<unsigned long long>((epoch << 2) | status) << 32) |
      static_cast<uint32_t>(value);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

// Wait for tile i's flag of this epoch; its status and value.
__device__ __forceinline__ uint32_t wait_flag(const unsigned long long* flags, int32_t i,
                                              uint32_t epoch, int32_t* value) {
  unsigned long long f;
  do {
    f = load_flag(flags + i);
  } while (static_cast<uint32_t>(f >> 34) != epoch || ((f >> 32) & 3u) == 0u);
  *value = static_cast<int32_t>(static_cast<uint32_t>(f));
  return static_cast<uint32_t>(f >> 32) & 3u;
}

// Four mask bytes -> four bits, bit k set where byte k is not 0.
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// `vec_bytes` lanes from p (aligned to vec_bytes) as bits.
__device__ __forceinline__ uint32_t mask_bits(const uint8_t* p, int vec_bytes) {
  if (vec_bytes == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 | nibble(v.w) << 12;
  }
  if (vec_bytes == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return nibble(v.x) | nibble(v.y) << 4;
  }
  if (vec_bytes == 4) return nibble(*reinterpret_cast<const uint32_t*>(p));
  return *p != 0;
}

// The exclusive prefix of v over the block, and the block's total.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sums,
                                                        int32_t* block_total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[w] = incl;
  __syncthreads();
  if (w == 0) {
    int32_t s = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  *block_total = warp_sums[kThreads / 32 - 1];
  return incl - v + (w > 0 ? warp_sums[w - 1] : 0);
}

// Warp 0 of tile `tile` (> 0): the sum of every earlier tile's lanes, from
// the nearest inclusive prefix and the aggregates after it.
__device__ __forceinline__ int32_t look_back(const unsigned long long* flags, int32_t tile,
                                             uint32_t epoch) {
  const int lane = threadIdx.x & 31;
  int32_t prefix = 0;
  for (int32_t base = tile - 1;; base -= 32) {
    const int32_t i = base - lane;
    int32_t v = 0;
    const uint32_t status = i >= 0 ? wait_flag(flags, i, epoch, &v) : kInclusive;
    const unsigned inclusive = __ballot_sync(kFull, status == kInclusive);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    int32_t part = lane <= stop ? v : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
    prefix += part;
    if (inclusive) return prefix;
  }
}

// Rows [f * kThreads * kFillRows, ...) of the buffer once the last tile's
// prefix (the kept total) is out: live[b] = b < total, src[b] = 0 past it.
__device__ __forceinline__ void fill_rows(const StageArgs& a, int32_t f, int32_t& s_total) {
  if (threadIdx.x == 0) {
    int32_t sum = 0;  // the last tile's inclusive prefix: every kept lane
    if (a.n_tiles > 0)
      while (wait_flag(a.flags, a.n_tiles - 1, a.epoch, &sum) != kInclusive) {
      }
    const int32_t total = sum < a.budget ? sum : a.budget;
    if (a.n_tiles == 0 && f == 0) *a.total = 0;
    s_total = total;
  }
  __syncthreads();
  const int32_t total = s_total;
  const int64_t b0 = static_cast<int64_t>(f) * kThreads * kFillRows + threadIdx.x;
#pragma unroll
  for (int q = 0; q < kFillRows; ++q) {
    const int64_t b = b0 + q * kThreads;
    if (b < a.budget) {
      a.live[b] = b < total ? 1.0f : 0.0f;
      if (b >= total) a.src[b] = 0;
    }
  }
}

// FLAT: tiles of kTileLanes lanes of the flattened (R, L), rays crossing
// them (tile_rays 0); else tiles of tile_rays whole rays.
template <bool FLAT>
__global__ void __launch_bounds__(kThreads) compact_stage_kernel(const StageArgs a) {
  __shared__ uint32_t s_ticket;
  __shared__ int32_t s_warp_sums[kThreads / 32];
  __shared__ int32_t s_prefix;  // the tile's exclusive prefix, or a fill block's total
  __shared__ int32_t s_ray_slot[FLAT ? 1 : kTileLanes];  // each ray's first slot
  if (threadIdx.x == 0) {
    const uint32_t t = atomicAdd(a.ticket, 1u);
    if (t == gridDim.x - 1) atomicExch(a.ticket, 0u);  // every ticket is taken
    s_ticket = t;
  }
  __syncthreads();
  const int32_t tile = static_cast<int32_t>(s_ticket);
  if (tile >= a.n_tiles) {
    fill_rows(a, tile - a.n_tiles, s_prefix);
    return;
  }
  // the tile's first ray r0 and rays nr (whole-ray tiles), its first flat
  // lane f0 and its lanes n (R * L < 2^31: 32-bit lane arithmetic)
  int32_t f0, nr, n;
  int64_t r0;
  if (FLAT) {
    f0 = tile * kTileLanes;
    r0 = 0;
    nr = 0;
    n = min(kTileLanes, a.R * a.L - f0);
  } else {
    r0 = static_cast<int64_t>(tile) * a.tile_rays;
    nr = static_cast<int32_t>(min(static_cast<int64_t>(a.tile_rays), a.R - r0));
    f0 = static_cast<int32_t>(r0) * a.L;
    n = nr * a.L;
  }
  const int32_t p0 = threadIdx.x * kLanesPerThread;

  // this thread's lanes [p0, p0 + 16) as bits: chunks of vec_bytes lanes
  // never cross a ray (vec_bytes divides L, and f0 + p0 is a multiple of 16)
  uint32_t bits = 0;
  for (int32_t q = 0; q < kLanesPerThread && p0 + q < n; q += a.vec_bytes) {
    const int32_t pq = (FLAT ? f0 : 0) + p0 + q;  // a lane of the tile, or the flat lane
    const int32_t i = pq / a.L, l = pq - i * a.L;
    const int64_t r = (FLAT ? 0 : r0) + i;
    if (a.live_rays != nullptr && a.live_rays[r] == 0) continue;
    bits |= mask_bits(a.mask + r * a.stride + l, a.vec_bytes) << q;
  }
  int32_t agg;
  const int32_t excl = block_exclusive_scan(__popc(bits), s_warp_sums, &agg);
  if (threadIdx.x < 32) {
    int32_t prefix = 0;
    if (tile == 0) {
      if (threadIdx.x == 0) store_flag(a.flags, a.epoch, kInclusive, agg);
    } else {
      if (threadIdx.x == 0) store_flag(a.flags + tile, a.epoch, kAggregate, agg);
      prefix = look_back(a.flags, tile, a.epoch);
      if (threadIdx.x == 0) store_flag(a.flags + tile, a.epoch, kInclusive, prefix + agg);
    }
    if (threadIdx.x == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int32_t prefix = s_prefix;

  // slot, kept and src of this thread's lanes, four at a time; each ray's
  // first slot (on flat tiles, its starts)
  const int64_t flat0 = static_cast<int64_t>(f0) + p0;
  const int32_t first = prefix + excl;
  const bool whole = p0 + kLanesPerThread <= n;  // 64 bytes of slot, 16 of kept
  // the ray (within the tile, or the absolute ray on flat tiles) and lane of p0
  int32_t i = (FLAT ? f0 + p0 : p0) / a.L;
  int32_t l = (FLAT ? f0 + p0 : p0) - i * a.L;
  uint32_t keep_bytes[kLanesPerThread / 4];
#pragma unroll
  for (int k = 0; k < kLanesPerThread / 4; ++k) {
    int32_t s4[4];
    keep_bytes[k] = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * k + q;
      const int32_t s = first + __popc(bits & ((1u << j) - 1u));
      const bool keep = ((bits >> j) & 1u) && s < a.budget;
      s4[q] = s;
      keep_bytes[k] |= static_cast<uint32_t>(keep) << (8 * q);
      if (p0 + j < n) {
        if (keep) a.src[s] = flat0 + j;
        if (l == 0) {
          if (FLAT)
            a.starts[i] = s < a.budget ? s : a.budget;
          else
            s_ray_slot[i] = s;
        }
        if (!whole) {
          a.slot[flat0 + j] = s;
          a.kept[flat0 + j] = keep;
        }
      }
      if (++l == a.L) {
        l = 0;
        ++i;
      }
    }
    if (whole)
      reinterpret_cast<int4*>(a.slot + flat0)[k] = make_int4(s4[0], s4[1], s4[2], s4[3]);
  }
  if (whole)
    *reinterpret_cast<uint4*>(a.kept + flat0) =
        make_uint4(keep_bytes[0], keep_bytes[1], keep_bytes[2], keep_bytes[3]);
  const int32_t end = prefix + agg;
  if (FLAT) {  // the counts follow in ray_counts_kernel
    if (tile == a.n_tiles - 1 && threadIdx.x == 0) *a.total = end < a.budget ? end : a.budget;
    return;
  }
  __syncthreads();

  // each ray's counts and starts after the drop
  for (int32_t k = threadIdx.x; k < nr; k += kThreads) {
    const int32_t off = s_ray_slot[k];
    const int32_t c = (k + 1 < nr ? s_ray_slot[k + 1] : end) - off;
    const int32_t room = a.budget - off;
    a.counts[r0 + k] = room <= 0 ? 0 : (c < room ? c : room);
    a.starts[r0 + k] = off < a.budget ? off : a.budget;
  }
  if (tile == a.n_tiles - 1 && threadIdx.x == 0) *a.total = end < a.budget ? end : a.budget;
}

// After K6a on flat tiles: counts[r] = starts[r + 1] - starts[r], the
// total past the last ray (starts and total clamped to the budget, so these
// are the kept lanes).
__global__ void __launch_bounds__(kThreads)
ray_counts_kernel(const int64_t* __restrict__ starts, const int32_t* __restrict__ total,
                  int64_t* __restrict__ counts, int32_t R) {
  const int32_t r = blockIdx.x * kThreads + threadIdx.x;
  if (r < R) counts[r] = (r + 1 < R ? starts[r + 1] : *total) - starts[r];
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
// `stride` (bytes); live_rays: (R,) bool or null; budget: Bs. tile_rays:
// rays a tile (tile_rays * L <= 4,096 and a multiple of 16), or 0 for flat
// tiles of 4,096 lanes (then a second launch for the counts); vec_bytes: 1,
// 4, 8 or 16, dividing L, stride and the mask's address. workspace: the
// ticket (the first 8 bytes, 0 between launches) then flag_capacity flags,
// one a tile; epoch: 1 to 2^30 - 1, another than the workspace's last
// launch's. Outputs: slot (R * L) int32, kept (R * L) bool, src (Bs) int64,
// live (Bs) f32, counts and starts (R) int64, total (1) int32. 1 <= L; R
// * L and Bs below 2^31. Returns a cudaError_t.
extern "C" int umhs_compact_stage(const uint8_t* mask, int64_t stride, const uint8_t* live_rays,
                                  int32_t R, int32_t L, int32_t budget, int32_t tile_rays,
                                  int32_t vec_bytes, void* workspace, int32_t flag_capacity,
                                  uint32_t epoch, int32_t* slot, uint8_t* kept, int64_t* src,
                                  float* live, int64_t* counts, int64_t* starts, int32_t* total,
                                  void* stream, int32_t* route) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  if (R < 0 || L < 1 || budget < 1 || stride < L || tile_rays < 0 ||
      static_cast<int64_t>(tile_rays) * L > kTileLanes || (tile_rays * L) % kLanesPerThread != 0 ||
      !(vec_bytes == 1 || vec_bytes == 4 || vec_bytes == 8 || vec_bytes == 16) ||
      L % vec_bytes != 0 || stride % vec_bytes != 0 || addr % vec_bytes != 0 || epoch < 1 ||
      epoch >= (1u << 30) || static_cast<int64_t>(R) * L >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  const bool flat = tile_rays == 0;
  *route = flat ? 1 : 0;  // umhs_torch/ops/compact.py's COMPACT_ROUTES
  const int64_t n_tiles = flat ? (static_cast<int64_t>(R) * L + kTileLanes - 1) / kTileLanes
                               : (static_cast<int64_t>(R) + tile_rays - 1) / tile_rays;
  if (n_tiles > flag_capacity) return cudaErrorInvalidValue;
  const int64_t n_fill = (static_cast<int64_t>(budget) + kThreads * kFillRows - 1) /
                         (kThreads * kFillRows);
  StageArgs args{mask, stride, live_rays, R, L, budget, tile_rays, vec_bytes,
                 static_cast<int32_t>(n_tiles), epoch,
                 static_cast<unsigned long long*>(workspace) + 1,
                 static_cast<unsigned int*>(workspace), slot, kept, src, live, counts, starts,
                 total};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(n_tiles + n_fill);
  if (!flat) {
    compact_stage_kernel<false><<<blocks, kThreads, 0, s>>>(args);
    return cudaGetLastError();
  }
  compact_stage_kernel<true><<<blocks, kThreads, 0, s>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || R == 0) return err;
  ray_counts_kernel<<<static_cast<unsigned>((R + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      starts, total, counts, R);
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
