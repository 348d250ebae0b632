// The hash grid's vertex rows and interpolation weights, shared by K3 (the
// forward, hash_encode_fwd.cu) and K4 (the backward, hash_encode_bwd.cu) so
// the backward scatters to exactly the rows the forward gathered.
//
// For a position p in [0, 1]^3 and a level l: s = p * scale_l + 0.5 per axis
// (two roundings, no FMA, so the cell is the one the plain version picks),
// floor and frac; then the 4 tetrahedral vertices (ranks of the three fracs,
// ties broken by axis order as umhs_tpu/ops/encodings.py:400-403) or the 8
// trilinear corners. Corner coordinates are clipped to res_l - 1; the row is
// the dense linear index when res_l^3 fits the hashmap, else the XOR-prime
// hash in wrapping uint32 masked to the hashmap size; plus the level offset.
#pragma once

#include <stdint.h>

namespace umhs {

constexpr int kMaxLevels = 32;

struct Levels {
  float scale[kMaxLevels];
  int res[kMaxLevels];
  int offset[kMaxLevels];
  int dense[kMaxLevels];
  uint32_t hash_mask;  // hashmap_size - 1 (a power of two)
};

// Fills `lv` from per-level host arrays; false when the sizes are not taken.
inline bool fill_levels(Levels& lv, int L, const float* scales, const int* res,
                        const int* offsets, const int* dense, int log2_hashmap_size) {
  if (L < 1 || L > kMaxLevels || log2_hashmap_size < 1 || log2_hashmap_size > 31) return false;
  lv = Levels{};
  for (int l = 0; l < L; ++l) {
    lv.scale[l] = scales[l];
    lv.res[l] = res[l];
    lv.offset[l] = offsets[l];
    lv.dense[l] = dense[l];
  }
  lv.hash_mask = (1u << log2_hashmap_size) - 1u;
  return true;
}

__device__ __forceinline__ uint32_t row_index(int cx, int cy, int cz, int res, bool dense,
                                              uint32_t mask) {
  const uint32_t x = cx, y = cy, z = cz;
  if (dense) {
    const uint32_t r = res;
    return x + y * r + z * r * r;
  }
  return (x * 1u ^ y * 2654435761u ^ z * 805459861u) & mask;
}

__device__ __forceinline__ int clip_coord(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// Table rows and weights of the V = 4 (tetrahedral) or 8 (trilinear)
// vertices of position p at level l.
template <bool kTetra>
__device__ __forceinline__ void hash_vertices(const float p[3], int l, const Levels& lv,
                                              uint32_t* rows, float* w) {
  const float scale = lv.scale[l];
  const int res_m1 = lv.res[l] - 1;
  const bool dense = lv.dense[l] != 0;
  const uint32_t off = static_cast<uint32_t>(lv.offset[l]);
  int b[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float sa = __fadd_rn(__fmul_rn(p[a], scale), 0.5f);
    const float fl = floorf(sa);
    b[a] = static_cast<int>(fl);
    f[a] = __fsub_rn(sa, fl);
  }
  if (kTetra) {
    // ranks 0..2 (0 = largest frac), ties broken by axis order
    const int rx = (f[0] < f[1]) + (f[0] < f[2]);
    const int ry = (f[1] <= f[0]) + (f[1] < f[2]);
    const int rz = (f[2] <= f[0]) + (f[2] <= f[1]);
    const float fmax = fmaxf(f[0], fmaxf(f[1], f[2]));
    const float fmin = fminf(f[0], fminf(f[1], f[2]));
    const float fmid = __fsub_rn(__fsub_rn(__fadd_rn(__fadd_rn(f[0], f[1]), f[2]), fmax), fmin);
    w[0] = __fsub_rn(1.f, fmax);
    w[1] = __fsub_rn(fmax, fmid);
    w[2] = __fsub_rn(fmid, fmin);
    w[3] = fmin;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int cx = clip_coord(b[0] + (rx < v), res_m1);
      const int cy = clip_coord(b[1] + (ry < v), res_m1);
      const int cz = clip_coord(b[2] + (rz < v), res_m1);
      rows[v] = row_index(cx, cy, cz, lv.res[l], dense, lv.hash_mask) + off;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
      const float wx = ox ? f[0] : __fsub_rn(1.f, f[0]);
      const float wy = oy ? f[1] : __fsub_rn(1.f, f[1]);
      const float wz = oz ? f[2] : __fsub_rn(1.f, f[2]);
      w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
      rows[c] = row_index(clip_coord(b[0] + ox, res_m1), clip_coord(b[1] + oy, res_m1),
                          clip_coord(b[2] + oz, res_m1), lv.res[l], dense, lv.hash_mask) + off;
    }
  }
}

}  // namespace umhs
