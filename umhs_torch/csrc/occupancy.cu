// K7: the occupancy grid's update, in three launches around the density
// evaluation (which stays K3 and K1).
//
// Replaces the XLA code of umhs_tpu/ops/occupancy.py:347 `update_occ_state`:
// the partial update's cell choice (:366-407), the probes' world positions
// (`_level_world_positions`), the EMA and the lower envelope at the probed
// cells (:413-437), the threshold (:439), the max-pool (`_pool_binaries`
// :88) and the 64-bit packing (`_pack_supercell_words` :97). In the original
// system nerfacc's OccGridEstimator did this work in CUDA.
//
// K7a (umhs_occ_update), one thread a probe:
// - mode 0, before the density: the probe's world position. A partial
//   update probes given (level, cell) pairs, or chooses them from the
//   draws: per level, half the cells uniform and half the occupied ones at
//   the stratified ranks floor((i + u_i) / m * count), each found through
//   one count pass over the bitfield (occ_cells_kernel: each slice's rows'
//   exclusive counts and the slice's count) by a binary search over the
//   slices' counts in shared memory, one over the slice's rows and a
//   popcount walk along the row's bytes; a level with no occupied cell takes
//   its fallback cells. Then, in place in the state's grids, at each probed
//   cell the values its probes share: occs * decay and max(occs_low * 2,
//   occ_thre). A bit a cell (atomicOr in a bitmap zeroed once an update)
//   lets exactly one probe of a cell write them, from the grid as it was.
// - mode 1, after the density: occ = nan_to_num(sigma * step). Full:
//   occs_out = max(occs * decay, occ), occs_low_out = min(occ, rise),
//   elementwise into new grids. Partial: integer atomicMax / atomicMin of
//   occ's bits into the values mode 0 wrote, which gives the largest probe
//   in occs and the smallest in occs_low, as the plain version's
//   scatter_reduce does. This is exact because no value is negative: occs
//   starts at 0 and only takes maxima with occ; occ is the field's density
//   (trunc_exp, or 0 outside the scene) times a positive step with NaN
//   mapped to 0; the rise is at least occ_thre > 0. For non-negative floats
//   the order of the bit patterns as int32 is the order of the values. No
//   float atomics.
// K7b (umhs_occ_pack): binaries = occs > min(mean, occ_thre), with the mean
// read on the device (torch.mean, no host sync). Where res % 4 == 0, one
// thread a 4^3 supercell, a warp's threads along x: 16 float4 loads, one a
// (sy, sz) row of 4 cells, whose bits go into the 64-bit word in registers
// (bit sx + 4 sy + 16 sz), each row's 4 bytes stored as one 32-bit word, the
// word as its [lo, hi] int64 halves in one 16-byte store (the port's layout,
// which checkpoints and convert.py read), and with pool 4 the pooled byte
// (lo | hi) != 0. Otherwise a thread a cell; a pool other than 4 then takes
// one more pass, a thread a pooled cell.
//
// The arithmetic follows PyTorch's CUDA kernels op by op (occupancy.cuh),
// so every output equals the plain version's on the card bit for bit.
//
// What bounds it on an H100: bytes. A full update at 4 x 128^3 reads the
// 33.5 MB occs and occs_low and the 100 MB jitter, writes the 100 MB
// positions, then reads occs, occs_low and the densities and writes occs
// and occs_low; K7b reads occs once and writes 10.5 MB of bits. A partial
// one reads the 8.4 MB bitfield once, each probe's draw and jitter and
// writes its position and cell, and reads and writes the grids only at the
// probed cells: it copies no grid.
#include <stdint.h>

#include "common.cuh"
#include "occupancy.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? 3.402823466e38f : -3.402823466e38f;
  return v;
}

// Word w of `bytes` (4-byte aligned) as an aligned 32-bit word, its bytes
// outside [start, start + len) masked off: its popcount counts the range's
// set bytes (each 0 or 1). The last word may reach up to 3 bytes past the
// tensor's end, inside its allocation (PyTorch's allocator rounds every
// block to 512 bytes).
__device__ __forceinline__ unsigned range_word(const uint8_t* __restrict__ bytes, int64_t start,
                                               int64_t len, int64_t w) {
  unsigned v = __ldg(reinterpret_cast<const unsigned*>(bytes) + w);
  const int64_t lo = start - 4 * w, hi = start + len - 4 * w;
  if (lo > 0) v &= 0xffffffffu << (8 * lo);
  if (hi < 4) v &= (1u << (8 * hi)) - 1u;
  return v;
}

// One warp's exclusive scan of v[0, n) into out[0, n), 32 at a time with
// a carry; returns the sum.
__device__ __forceinline__ int32_t warp_scan_into(const int32_t* v, int32_t* out, int n,
                                                  int lane) {
  int32_t carry = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int32_t c = i0 + lane < n ? v[i0 + lane] : 0;
    int32_t x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += t;
    }
    if (i0 + lane < n) out[i0 + lane] = carry + x - c;
    carry += __shfl_sync(kFull, x, 31);
  }
  return carry;
}

// Slice `slice` (level * res + z) of the bitfield: its rows' counts of set
// bytes, their exclusive running count in the slice and the slice's count.
// One block a slice, a warp a row at a time (four rows' loads in flight).
__global__ void __launch_bounds__(kThreads)
occ_cells_kernel(const umhs::OccParams g, const uint8_t* __restrict__ binaries,
                 int32_t* __restrict__ row_excl, int32_t* __restrict__ slice_count) {
  extern __shared__ int32_t row_count[];  // res
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t res = g.res, slice = blockIdx.x;
  for (int y0 = 4 * warp; y0 < res; y0 += 4 * kWarps) {
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = 0;
      if (y0 + j < res) {
        const int64_t start = (slice * res + y0 + j) * res;
        for (int64_t w = (start >> 2) + lane; w < (start + res + 3) >> 2; w += 32)
          v[j] += __popc(range_word(binaries, start, res, w));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = __reduce_add_sync(kFull, v[j]);
      if (lane == 0 && y0 + j < res) row_count[y0 + j] = c;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int32_t total = warp_scan_into(row_count, row_excl + slice * res, g.res, lane);
    if (lane == 0) slice_count[slice] = total;
  }
}

// Position of the n-th (0-based) set bit of w (n < popc(w)).
__device__ __forceinline__ int nth_set_bit(unsigned w, int n) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc(w & ((1u << width) - 1u));
    if (n >= c) {
      n -= c;
      w >>= width;
      pos += width;
    }
  }
  return pos;
}

// The largest i in [0, len) with v[i] <= key (v non-decreasing, v[0] <= key).
__device__ __forceinline__ int last_at_most(const int32_t* v, int len, int64_t key) {
  int lo = 0, hi = len - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (v[mid] <= key) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The cell (in its level) of the occupied cell of rank `rank` (< the level's
// count) of level `lvl`: its slice, its row, its byte in the row.
__device__ __forceinline__ int64_t occupied_cell(const umhs::OccParams& g, int64_t lvl,
                                                 int64_t rank, const int32_t* slice_excl,
                                                 const int32_t* __restrict__ row_excl,
                                                 const uint8_t* __restrict__ binaries) {
  const int64_t res = g.res;
  const int z = last_at_most(slice_excl + lvl * res, g.res, rank);
  rank -= slice_excl[lvl * res + z];
  const int32_t* rows = row_excl + (lvl * res + z) * res;
  const int y = last_at_most(rows, g.res, rank);
  int n = static_cast<int>(rank - __ldg(rows + y));
  const int64_t start = ((lvl * res + z) * res + y) * res;
  int64_t x = res - 1;
  for (int64_t w = start >> 2; w < (start + res + 3) >> 2; ++w) {
    const unsigned v = range_word(binaries, start, res, w);
    const int c = __popc(v);
    if (n < c) {
      x = 4 * w + (nth_set_bit(v, n) >> 3) - start;
      break;
    }
    n -= c;
  }
  return x + y * res + z * res * res;
}

// The probed cell of probe i: every cell of every level (full), the given
// (level, cell) pairs, or the one chosen from the draws (partial_cells'
// rule: the level's uniform cells, then its occupied cells at stratified
// ranks, or its fallback cells when it has none).
__device__ __forceinline__ void probe_cell(const umhs::OccParams& g,
                                           const umhs::DrawLevel* __restrict__ D,
                                           const int64_t* __restrict__ uniform,
                                           const float* __restrict__ u,
                                           const int64_t* __restrict__ fallback, int64_t i,
                                           const int64_t* __restrict__ level,
                                           const int64_t* __restrict__ cell,
                                           const int32_t* slice_excl, const int32_t* level_count,
                                           const int32_t* __restrict__ row_excl,
                                           const uint8_t* __restrict__ binaries, int64_t& lvl,
                                           int64_t& c) {
  const int64_t res3 = static_cast<int64_t>(g.res) * g.res * g.res;
  if (D != nullptr) {
    lvl = 0;
    while (i >= D[lvl + 1].start) ++lvl;
    const umhs::DrawLevel& d = D[lvl];
    const int64_t j = i - d.start - d.uniform_n;
    if (j < 0) {
      c = uniform[d.uniform_at + j + d.uniform_n];
      return;
    }
    const int32_t count = level_count[lvl];
    if (count == 0) {
      c = fallback[d.occupied_at + j];
      return;
    }
    // (arange + u) / m, then * count: the plain version's f32 roundings
    const float strat =
        __fmul_rn(__fadd_rn(static_cast<float>(j), u[d.occupied_at + j]), d.inv_occ_n);
    const int64_t rank =
        static_cast<int64_t>(floorf(__fmul_rn(strat, static_cast<float>(count))));
    c = rank < count ? occupied_cell(g, lvl, rank, slice_excl, row_excl, binaries) : res3 - 1;
  } else if (level != nullptr) {
    lvl = level[i];
    c = cell[i];
  } else {
    lvl = i / res3;
    c = i - lvl * res3;
  }
}

__global__ void __launch_bounds__(kThreads)
occ_probe_kernel(const umhs::OccParams g, const umhs::DrawLevel* __restrict__ D,
                 const int64_t* __restrict__ uniform, const float* __restrict__ u,
                 const int64_t* __restrict__ fallback, int64_t n,
                 const int64_t* __restrict__ level, const int64_t* __restrict__ cell,
                 const int32_t* __restrict__ row_excl, const int32_t* __restrict__ slice_count,
                 const uint8_t* __restrict__ binaries, const float* __restrict__ jitter,
                 float* __restrict__ positions, float* occs, float* occs_low,
                 int32_t* __restrict__ flat_out, unsigned* __restrict__ seen) {
  // with draws: each level's slices' exclusive running counts, then the
  // levels' counts (a warp a level)
  extern __shared__ int32_t slice_excl[];  // levels * res + levels
  const int64_t res = g.res;
  if (D != nullptr) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int l = warp; l < g.levels; l += kWarps) {
      const int32_t total =
          warp_scan_into(slice_count + l * res, slice_excl + l * res, g.res, lane);
      if (lane == 0) slice_excl[g.levels * res + l] = total;
    }
    __syncthreads();
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t lvl, c;
  probe_cell(g, D, uniform, u, fallback, i, level, cell, slice_excl, slice_excl + g.levels * res, row_excl,
             binaries, lvl, c);
  const int64_t ijk[3] = {c % res, (c / res) % res, c / (res * res)};
  const float scale = exp2f(static_cast<float>(lvl));
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // (ijk / res + jitter / res) * 2 - 1, then center + unit * half * scale
    const float unit = __fsub_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(static_cast<float>(ijk[a]), g.inv_res),
                            __fmul_rn(jitter[3 * i + a], g.inv_res)),
                  2.0f),
        1.0f);
    positions[3 * i + a] = __fadd_rn(g.center[a], __fmul_rn(__fmul_rn(unit, g.half[a]), scale));
  }
  if (flat_out != nullptr) {  // partial: the cell's shared values, once a cell
    const int64_t flat = lvl * res * res * res + c;
    flat_out[i] = static_cast<int32_t>(flat);
    const unsigned bit = 1u << (flat & 31);
    if ((atomicOr(seen + (flat >> 5), bit) & bit) == 0u) {
      occs[flat] = __fmul_rn(occs[flat], g.decay);
      occs_low[flat] = umhs::clamp_min_f(__fmul_rn(occs_low[flat], 2.0f), g.occ_thre);
    }
  }
}

// Full: the EMA and the envelope elementwise, into new grids.
__global__ void __launch_bounds__(kThreads)
occ_ema_kernel(const umhs::OccParams g, int64_t n, const float* __restrict__ occs,
               const float* __restrict__ occs_low, const float* __restrict__ sigma,
               float* __restrict__ occs_out, float* __restrict__ occs_low_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float occ = nan_to_num(__fmul_rn(sigma[i], g.step));
  occs_out[i] = umhs::maximum_f(__fmul_rn(occs[i], g.decay), occ);
  const float rise = umhs::clamp_min_f(__fmul_rn(occs_low[i], 2.0f), g.occ_thre);
  occs_low_out[i] = umhs::minimum_f(occ, rise);
}

// Partial: each probe's occ into its cell, in place.
__global__ void __launch_bounds__(kThreads)
occ_fold_kernel(const umhs::OccParams g, int64_t n, const int32_t* __restrict__ flat,
                const float* __restrict__ sigma, float* occs, float* occs_low) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float occ = nan_to_num(__fmul_rn(sigma[i], g.step));
  atomicMax(reinterpret_cast<int*>(occs) + flat[i], __float_as_int(occ));
  atomicMin(reinterpret_cast<int*>(occs_low) + flat[i], __float_as_int(occ));
}

__device__ __forceinline__ float threshold_of(const umhs::OccParams& g,
                                              const float* __restrict__ mean) {
  return umhs::clamp_max_f(*mean, g.occ_thre);
}

// res % 4 == 0: one thread a supercell (L x (res/4)^3 of them), the threads
// of a warp along X, so a warp's load of one (sy, sz) row of its supercells
// is 512 contiguous bytes. A row is 16-byte aligned because res % 4 == 0 and
// the wrapper checks occs; binaries and packed come from the wrapper's own
// allocations, aligned for the 4- and 16-byte stores.
__global__ void __launch_bounds__(kThreads)
occ_pack_kernel(const umhs::OccParams g, const float* __restrict__ occs,
                const float* __restrict__ mean, uint8_t* __restrict__ binaries,
                int64_t* __restrict__ packed, uint8_t* __restrict__ pooled) {
  const int64_t r4 = g.res >> 2, res = g.res;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (w >= g.levels * r4 * r4 * r4) return;
  const float thre = threshold_of(g, mean);
  // w = ((lvl r4 + Z) r4 + Y) r4 + X, and lvl res^3 + z res^2 = (4 (lvl r4
  // + Z) + sz) res^2: the supercell's first cell from two divisions
  const int64_t lz = w / (r4 * r4), yx = w - lz * r4 * r4;
  const int64_t Y = yx / r4, X = yx - Y * r4;
  const int64_t first = 4 * (X + Y * res + lz * res * res);
  unsigned half[2] = {0u, 0u};
#pragma unroll
  for (int sz = 0; sz < 4; ++sz) {
#pragma unroll
    for (int sy = 0; sy < 4; ++sy) {
      const int64_t row = first + sy * res + sz * res * res;
      const float4 v = __ldg(reinterpret_cast<const float4*>(occs + row));
      const unsigned b0 = v.x > thre, b1 = v.y > thre, b2 = v.z > thre, b3 = v.w > thre;
      *reinterpret_cast<unsigned*>(binaries + row) = b0 | b1 << 8 | b2 << 16 | b3 << 24;
      half[sz >> 1] |= (b0 | b1 << 1 | b2 << 2 | b3 << 3) << (4 * sy + 16 * (sz & 1));
    }
  }
  reinterpret_cast<longlong2*>(packed)[w] =
      make_longlong2(static_cast<long long>(half[0]), static_cast<long long>(half[1]));
  if (pooled != nullptr && g.pool == 4) pooled[w] = (half[0] | half[1]) != 0u;
}

// res % 4 != 0: a thread a cell.
__global__ void __launch_bounds__(kThreads)
occ_threshold_kernel(const umhs::OccParams g, const float* __restrict__ occs,
                     const float* __restrict__ mean, uint8_t* __restrict__ binaries) {
  const int64_t n = static_cast<int64_t>(g.levels) * g.res * g.res * g.res;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) binaries[i] = occs[i] > threshold_of(g, mean);
}

// A pool p other than the packed words' 4: a thread a pooled cell, any of
// its p^3 cells.
__global__ void __launch_bounds__(kThreads)
occ_pool_kernel(const umhs::OccParams g, const uint8_t* __restrict__ binaries,
                uint8_t* __restrict__ pooled) {
  const int p = g.pool, rp = g.res / p;
  const int64_t per_level = static_cast<int64_t>(rp) * rp * rp;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= g.levels * per_level) return;
  const int64_t lvl = i / per_level, rem = i - lvl * per_level;
  const int64_t X = rem % rp, Y = (rem / rp) % rp, Z = rem / (static_cast<int64_t>(rp) * rp);
  const int64_t res = g.res;
  bool any = false;
  for (int z = 0; z < p && !any; ++z)
    for (int y = 0; y < p && !any; ++y)
      for (int x = 0; x < p && !any; ++x)
        any = binaries[lvl * res * res * res + (p * X + x) + (p * Y + y) * res +
                       (p * Z + z) * res * res] != 0;
  pooled[i] = any;
}

unsigned blocks_for(int64_t threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int umhs_occ_params_size() { return static_cast<int>(sizeof(umhs::OccParams)); }

extern "C" int umhs_occ_draws_size() { return static_cast<int>(sizeof(umhs::DrawLevel)); }

// Mode 0 (the probes): full when `level` and `draws` are both null, else
// partial, from the pairs (level, cell) or chosen from `draws` (a device
// table of levels + 1 DrawLevel rows over the concatenated uniform cells,
// offsets u and fallback cells, occupancy.cuh; the count
// pass into `counts`: levels * res^2 rows' then levels * res slices'
// int32); a partial update zeroes `seen` (a bit a cell) and writes `flat`
// and the grids `occs`, `occs_low` in place. Mode 1 (the fold): partial
// when `flat` is given (into `occs`, `occs_low` in place), else full (into
// `occs_out`, `occs_low_out`).
extern "C" int umhs_occ_update(int mode, const umhs::OccParams* params,
                               const umhs::DrawLevel* draws, const int64_t* uniform,
                               const float* u, const int64_t* fallback, int64_t n,
                               const int64_t* level,
                               const int64_t* cell, const uint8_t* binaries, const float* jitter,
                               float* occs, float* occs_low, const float* sigma,
                               float* positions, float* occs_out, float* occs_low_out,
                               int32_t* flat, unsigned* seen, int32_t* counts,
                               cudaStream_t stream) {
  const umhs::OccParams g = *params;
  const int64_t res = g.res, cells = static_cast<int64_t>(g.levels) * res * res * res;
  if (mode == 0) {
    const bool partial = level != nullptr || draws != nullptr;
    size_t smem = 0;
    int32_t *row_excl = nullptr, *slice_count = nullptr;
    if (partial) {
      cudaError_t err = cudaMemsetAsync(seen, 0, ((cells + 31) / 32) * sizeof(unsigned), stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (draws != nullptr) {
      row_excl = counts;
      slice_count = counts + g.levels * res * res;
      occ_cells_kernel<<<static_cast<unsigned>(g.levels * res), kThreads, res * sizeof(int32_t),
                         stream>>>(g, binaries, row_excl, slice_count);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      smem = (g.levels * res + g.levels) * sizeof(int32_t);
      if (smem > 48 * 1024) {  // many levels at a fine resolution
        err = cudaFuncSetAttribute(occ_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
    }
    occ_probe_kernel<<<blocks_for(n), kThreads, smem, stream>>>(
        g, draws, uniform, u, fallback, n, level, cell, row_excl, slice_count, binaries, jitter,
        positions, occs, occs_low, partial ? flat : nullptr, seen);
  } else if (flat != nullptr) {
    occ_fold_kernel<<<blocks_for(n), kThreads, 0, stream>>>(g, n, flat, sigma, occs, occs_low);
  } else {
    occ_ema_kernel<<<blocks_for(n), kThreads, 0, stream>>>(g, n, occs, occs_low, sigma, occs_out,
                                                           occs_low_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int umhs_occ_pack(const umhs::OccParams* params, const float* occs, const float* mean,
                             uint8_t* binaries, int64_t* packed, uint8_t* pooled,
                             cudaStream_t stream) {
  const umhs::OccParams g = *params;
  const int64_t cells = static_cast<int64_t>(g.levels) * g.res * g.res * g.res;
  if (g.res % 4 == 0) {
    occ_pack_kernel<<<blocks_for(cells / 64), kThreads, 0, stream>>>(g, occs, mean, binaries,
                                                                    packed, pooled);
  } else {
    occ_threshold_kernel<<<blocks_for(cells), kThreads, 0, stream>>>(g, occs, mean, binaries);
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && pooled != nullptr && !(g.res % 4 == 0 && g.pool == 4)) {
    const int64_t rp = g.res / g.pool;
    occ_pool_kernel<<<blocks_for(g.levels * rp * rp * rp), kThreads, 0, stream>>>(g, binaries,
                                                                                  pooled);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
