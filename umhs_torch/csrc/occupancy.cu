// K7: the occupancy grid's update, in three launches around the density
// evaluation (which stays K3 and K1).
//
// Replaces the XLA code of umhs_tpu/ops/occupancy.py:347 `update_occ_state`:
// the probes' world positions (`_level_world_positions`), the EMA and the
// lower envelope at the probed cells (:413-437), the threshold (:439), the
// max-pool (`_pool_binaries` :88) and the 64-bit packing
// (`_pack_supercell_words` :97). In the original system nerfacc's
// OccGridEstimator did this work in CUDA.
//
// K7a (umhs_occ_update), one thread a probe:
// - mode 0, before the density: the probe's world position. In a partial
//   update it also writes, at the probe's cell, the values every probe of
//   that cell shares: occs_out = occs * decay and occs_low_out =
//   max(occs_low * 2, occ_thre) (a cell drawn twice gets the same value
//   twice).
// - mode 1, after the density: occ = nan_to_num(sigma * step). Full:
//   occs_out = max(occs * decay, occ), occs_low_out = min(occ, rise),
//   elementwise. Partial: integer atomicMax / atomicMin of occ's bits into
//   the values mode 0 wrote, which gives the largest probe in occs and the
//   smallest in occs_low, as the plain version's scatter_reduce does. This
//   is exact because no value is negative: occs starts at 0 and only takes
//   maxima with occ; occ is the field's density (trunc_exp, or 0 outside
//   the scene) times a positive step with NaN mapped to 0; the rise is at
//   least occ_thre > 0. For non-negative floats the order of the bit
//   patterns as int32 is the order of the values. No float atomics.
// K7b (umhs_occ_pack): binaries = occs > min(mean, occ_thre), with the mean
// read on the device (torch.mean, no host sync). Where res % 4 == 0, one
// warp a 4^3 supercell: each lane thresholds two cells (bits l and l + 32
// of the word, bit sx + 4 sy + 16 sz), two ballots give the [lo, hi] words,
// stored as int64 halves (the port's layout, which checkpoints and
// convert.py read), and with pool 4 the pooled byte is (lo | hi) != 0.
// Otherwise a thread a cell; a pool other than 4 then takes one more pass,
// a thread a pooled cell.
//
// The arithmetic follows PyTorch's CUDA kernels op by op (occupancy.cuh),
// so every output equals the plain version's on the card bit for bit.
//
// What bounds it on an H100: bytes. A full update at 4 x 128^3 reads the
// 33.5 MB occs and occs_low and the 100 MB jitter, writes the 100 MB
// positions, then reads occs, occs_low and the densities and writes occs
// and occs_low; K7b reads occs once and writes 10.5 MB of bits.
#include <stdint.h>

#include "common.cuh"
#include "occupancy.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.0f;
  if (isinf(v)) return v > 0.0f ? 3.402823466e38f : -3.402823466e38f;
  return v;
}

// The probed cell's level and flat cell index: given, or probe i of the
// full update (level i / res^3, cell i % res^3).
__device__ __forceinline__ void probe_cell(const umhs::OccParams& g, int64_t i,
                                           const int64_t* __restrict__ level,
                                           const int64_t* __restrict__ cell, int64_t& lvl,
                                           int64_t& c) {
  const int64_t res3 = static_cast<int64_t>(g.res) * g.res * g.res;
  if (level != nullptr) {
    lvl = level[i];
    c = cell[i];
  } else {
    lvl = i / res3;
    c = i - lvl * res3;
  }
}

__global__ void __launch_bounds__(kThreads)
occ_probe_kernel(const umhs::OccParams g, int64_t n, const int64_t* __restrict__ level,
                 const int64_t* __restrict__ cell, const float* __restrict__ jitter,
                 const float* __restrict__ occs, const float* __restrict__ occs_low,
                 float* __restrict__ positions, float* __restrict__ occs_out,
                 float* __restrict__ occs_low_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t lvl, c;
  probe_cell(g, i, level, cell, lvl, c);
  const int64_t res = g.res;
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
  if (level != nullptr) {
    const int64_t flat = lvl * res * res * res + c;
    occs_out[flat] = __fmul_rn(occs[flat], g.decay);
    occs_low_out[flat] = umhs::clamp_min_f(__fmul_rn(occs_low[flat], 2.0f), g.occ_thre);
  }
}

__global__ void __launch_bounds__(kThreads)
occ_ema_kernel(const umhs::OccParams g, int64_t n, const int64_t* __restrict__ level,
               const int64_t* __restrict__ cell, const float* __restrict__ occs,
               const float* __restrict__ occs_low, const float* __restrict__ sigma,
               float* __restrict__ occs_out, float* __restrict__ occs_low_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const float occ = nan_to_num(__fmul_rn(sigma[i], g.step));
  if (level == nullptr) {
    occs_out[i] = umhs::maximum_f(__fmul_rn(occs[i], g.decay), occ);
    const float rise = umhs::clamp_min_f(__fmul_rn(occs_low[i], 2.0f), g.occ_thre);
    occs_low_out[i] = umhs::minimum_f(occ, rise);
    return;
  }
  const int64_t res = g.res;
  const int64_t flat = level[i] * res * res * res + cell[i];
  atomicMax(reinterpret_cast<int*>(occs_out) + flat, __float_as_int(occ));
  atomicMin(reinterpret_cast<int*>(occs_low_out) + flat, __float_as_int(occ));
}

__device__ __forceinline__ float threshold_of(const umhs::OccParams& g,
                                              const float* __restrict__ mean) {
  return umhs::clamp_max_f(*mean, g.occ_thre);
}

// res % 4 == 0: one warp a supercell (L x (res/4)^3 of them).
__global__ void __launch_bounds__(kThreads)
occ_pack_kernel(const umhs::OccParams g, const float* __restrict__ occs,
                const float* __restrict__ mean, uint8_t* __restrict__ binaries,
                int64_t* __restrict__ packed, uint8_t* __restrict__ pooled) {
  const int r4 = g.res >> 2;
  const int64_t n_super = static_cast<int64_t>(g.levels) * r4 * r4 * r4;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_super) return;  // uniform over the warp
  const float thre = threshold_of(g, mean);
  const int64_t per_level = static_cast<int64_t>(r4) * r4 * r4;
  const int64_t lvl = w / per_level, rem = w - lvl * per_level;
  const int64_t X = rem % r4, Y = (rem / r4) % r4, Z = rem / (static_cast<int64_t>(r4) * r4);
  const int64_t res = g.res;
  unsigned halves[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int bit = lane + 32 * h;
    const int64_t x = 4 * X + (bit & 3), y = 4 * Y + ((bit >> 2) & 3), z = 4 * Z + (bit >> 4);
    const int64_t flat = lvl * res * res * res + x + y * res + z * res * res;
    const bool on = occs[flat] > thre;
    binaries[flat] = on;
    halves[h] = __ballot_sync(kFull, on);
  }
  if (lane == 0) {
    packed[2 * w] = static_cast<int64_t>(halves[0]);
    packed[2 * w + 1] = static_cast<int64_t>(halves[1]);
    if (pooled != nullptr && g.pool == 4) pooled[w] = (halves[0] | halves[1]) != 0u;
  }
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

extern "C" int umhs_occ_update(int mode, const umhs::OccParams* params, int64_t n,
                               const int64_t* level, const int64_t* cell, const float* jitter,
                               const float* occs, const float* occs_low, const float* sigma,
                               float* positions, float* occs_out, float* occs_low_out,
                               cudaStream_t stream) {
  const umhs::OccParams g = *params;
  if (mode == 0) {
    occ_probe_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        g, n, level, cell, jitter, occs, occs_low, positions, occs_out, occs_low_out);
  } else {
    occ_ema_kernel<<<blocks_for(n), kThreads, 0, stream>>>(g, n, level, cell, occs, occs_low,
                                                           sigma, occs_out, occs_low_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int umhs_occ_pack(const umhs::OccParams* params, const float* occs, const float* mean,
                             uint8_t* binaries, int64_t* packed, uint8_t* pooled,
                             cudaStream_t stream) {
  const umhs::OccParams g = *params;
  const int64_t cells = static_cast<int64_t>(g.levels) * g.res * g.res * g.res;
  if (g.res % 4 == 0) {
    occ_pack_kernel<<<blocks_for(cells / 2), kThreads, 0, stream>>>(g, occs, mean, binaries,
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
