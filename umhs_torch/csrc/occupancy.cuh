// The occupancy grid's constants and cell lookup, shared by K5 (march.cu)
// and K7 (occupancy.cu).
//
// Every float here follows PyTorch's CUDA kernels op by op, so that a kernel
// gives the plain version's bits on the card: each op that PyTorch runs as
// its own kernel rounds once (__fadd_rn, __fmul_rn, __fdiv_rn keep nvcc
// from contracting two of them into an FMA), a division by a Python number
// is a multiplication by its float32 reciprocal (PyTorch's CUDA division
// takes that path for a CPU scalar divisor), and a division by a tensor is
// IEEE division.
#pragma once

#include <math.h>
#include <stdint.h>

namespace umhs {

// The grid: `res`^3 cells a level, `levels` levels, level i covering the
// level-0 box (centre `center`, half side `half`) scaled by 2^i. Mirrors
// umhs_torch/ops/occupancy.py's OccParams field for field.
struct OccParams {
  int32_t res, levels, pool;
  float center[3], half[3];
  float inv_res;    // float32(1) / float32(res)
  float max_scale;  // 2^(levels - 1)
  float min_maxc;   // 1e-12: the clamp before log2
  float decay, occ_thre, step;
};

// A partial update's draws, level by level (umhs_torch/ops/occupancy.py's
// draw_partial_cells): every level's uniform cells, offsets u and fallback
// cells concatenated level after level, and a device table of levels + 1
// rows (`DrawLevel`, mirrored field for field there, built once per shape
// of the draws): level l's probes are [start of row l, start of row l + 1),
// its uniform_n uniform cells first (at uniform_at of the uniform cells),
// then its occupied ones (at occupied_at of u and of the fallback cells);
// the last row holds only the probes' total in start. Any number of levels.
struct DrawLevel {
  int64_t start;
  int64_t uniform_n;
  int64_t uniform_at;
  int64_t occupied_at;
  float inv_occ_n;  // float32(1) / float32(occupied draws), 0 for none
  int32_t pad;
};

// torch.clamp_min / clamp_max / maximum / minimum on float32: NaN passes.
__device__ __forceinline__ float clamp_min_f(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_f(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float maximum_f(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float minimum_f(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

struct CellIndex {
  int32_t lvl;
  int32_t ijk[3];  // clipped to [0, res - 1]
  bool inside;     // max |rel| <= 2^(levels - 1)
};

// The finest level containing a world position and its cell at resolution
// `res` (the grid's, or the pooled grid's): _level_and_unit and the
// clipping of query_grid_values / _packed_cell_index.
__device__ __forceinline__ CellIndex locate_cell(const OccParams& g, const float pos[3],
                                                 int32_t res) {
  float rel[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) rel[c] = __fdiv_rn(__fsub_rn(pos[c], g.center[c]), g.half[c]);
  const float maxc = fmaxf(fmaxf(fabsf(rel[0]), fabsf(rel[1])), fabsf(rel[2]));
  float l = ceilf(log2f(clamp_min_f(maxc, g.min_maxc)));
  l = fminf(fmaxf(l, 0.0f), static_cast<float>(g.levels - 1));
  CellIndex cell;
  cell.lvl = static_cast<int32_t>(l);
  cell.inside = maxc <= g.max_scale;
  // rel / 2^lvl as a product with 2^-lvl (built from its exponent bits,
  // lvl < 127): both round the same real number once, so the bits are the
  // division's, subnormals, signed zeros, infinities and NaN included
  const float inv_scale = __int_as_float((127 - cell.lvl) << 23);
  const float resf = static_cast<float>(res);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float unit = __fmul_rn(__fadd_rn(__fmul_rn(rel[c], inv_scale), 1.0f), 0.5f);
    const long long v = static_cast<long long>(floorf(__fmul_rn(unit, resf)));
    cell.ijk[c] = static_cast<int32_t>(v < 0 ? 0 : (v > res - 1 ? res - 1 : v));
  }
  return cell;
}

}  // namespace umhs
