// K3: multi-resolution hash-grid encode, forward.
//
// Replaces the forward of umhs_tpu/ops/encodings.py::_hash_encode_impl
// (lines 339-486: _lane_iw_tetra, _lane_indices_weights, _hash_lane_index,
// then one row gather and a per-level reduction). On the TPU that is XLA laid
// out by hand; this kernel plays the role tiny-cuda-nn's HashGrid had in the
// original system.
//
// One thread per (sample, level): s = x * scale_l + 0.5, floor and frac per
// axis, then either the 4 tetrahedral vertices (ranks of the three fracs,
// ties broken by axis order exactly as encodings.py:400-403) or the 8
// trilinear corners. Corner coordinates are clipped to res_l - 1; the row is
// the dense linear index when res_l^3 fits the hashmap, else the XOR-prime
// hash in wrapping uint32 masked to the hashmap size; plus the level offset.
// Each row's F features come in one vector load and sum_v w_v * row_v is
// accumulated in f32 into out[n, l * F + f].
//
// What bounds it on an H100: random row gathers. At L16xF2 2^19 the table is
// 48.8 MB, which nearly fits the 50 MB L2; each vertex touches one 32-byte
// sector for 8 useful bytes. Threads of one sample sit next to each other so
// the position loads are shared and the output row is written contiguously.
// The scale multiply and the +0.5 are kept as two roundings (no FMA) so the
// cell choice is the same as in the plain version.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;

struct Levels {
  float scale[kMaxLevels];
  int res[kMaxLevels];
  int offset[kMaxLevels];
  int dense[kMaxLevels];
  uint32_t hash_mask;  // hashmap_size - 1 (a power of two)
};

template <int F>
struct Row;
template <>
struct Row<1> {
  static __device__ __forceinline__ void add(const float* t, uint32_t i, float w, float* acc) {
    acc[0] = fmaf(w, __ldg(t + i), acc[0]);
  }
};
template <>
struct Row<2> {
  static __device__ __forceinline__ void add(const float* t, uint32_t i, float w, float* acc) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(t) + i);
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
  }
};
template <>
struct Row<4> {
  static __device__ __forceinline__ void add(const float* t, uint32_t i, float w, float* acc) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(t) + i);
    acc[0] = fmaf(w, v.x, acc[0]);
    acc[1] = fmaf(w, v.y, acc[1]);
    acc[2] = fmaf(w, v.z, acc[2]);
    acc[3] = fmaf(w, v.w, acc[3]);
  }
};
template <>
struct Row<8> {
  static __device__ __forceinline__ void add(const float* t, uint32_t i, float w, float* acc) {
    const float4* p = reinterpret_cast<const float4*>(t) + 2 * static_cast<size_t>(i);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    acc[0] = fmaf(w, a.x, acc[0]);
    acc[1] = fmaf(w, a.y, acc[1]);
    acc[2] = fmaf(w, a.z, acc[2]);
    acc[3] = fmaf(w, a.w, acc[3]);
    acc[4] = fmaf(w, b.x, acc[4]);
    acc[5] = fmaf(w, b.y, acc[5]);
    acc[6] = fmaf(w, b.z, acc[6]);
    acc[7] = fmaf(w, b.w, acc[7]);
  }
};

__device__ __forceinline__ uint32_t row_index(int cx, int cy, int cz, int res,
                                              bool dense, uint32_t mask) {
  const uint32_t x = cx, y = cy, z = cz;
  if (dense) {
    const uint32_t r = res;
    return x + y * r + z * r * r;
  }
  return (x * 1u ^ y * 2654435761u ^ z * 805459861u) & mask;
}

__device__ __forceinline__ int clip(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

template <int F, bool kTetra>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                       float* __restrict__ out, int64_t n, int L, Levels lv) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * L) return;
  const int64_t s = t / L;
  const int l = static_cast<int>(t - s * L);
  const float scale = lv.scale[l];
  const int res_m1 = lv.res[l] - 1;
  const bool dense = lv.dense[l] != 0;

  int b[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float sa = __fadd_rn(__fmul_rn(__ldg(pos + 3 * s + a), scale), 0.5f);
    const float fl = floorf(sa);
    b[a] = static_cast<int>(fl);
    f[a] = __fsub_rn(sa, fl);
  }

  float acc[F];
#pragma unroll
  for (int i = 0; i < F; ++i) acc[i] = 0.f;
  const uint32_t off = static_cast<uint32_t>(lv.offset[l]);

  if (kTetra) {
    // ranks 0..2 (0 = largest frac), ties broken by axis order
    const int rx = (f[0] < f[1]) + (f[0] < f[2]);
    const int ry = (f[1] <= f[0]) + (f[1] < f[2]);
    const int rz = (f[2] <= f[0]) + (f[2] <= f[1]);
    const float fmax = fmaxf(f[0], fmaxf(f[1], f[2]));
    const float fmin = fminf(f[0], fminf(f[1], f[2]));
    const float fmid = __fsub_rn(__fsub_rn(__fadd_rn(__fadd_rn(f[0], f[1]), f[2]), fmax), fmin);
    const float w[4] = {__fsub_rn(1.f, fmax), __fsub_rn(fmax, fmid), __fsub_rn(fmid, fmin), fmin};
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int cx = clip(b[0] + (rx < v), res_m1);
      const int cy = clip(b[1] + (ry < v), res_m1);
      const int cz = clip(b[2] + (rz < v), res_m1);
      const uint32_t idx = row_index(cx, cy, cz, lv.res[l], dense, lv.hash_mask) + off;
      Row<F>::add(table, idx, w[v], acc);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
      const float wx = ox ? f[0] : __fsub_rn(1.f, f[0]);
      const float wy = oy ? f[1] : __fsub_rn(1.f, f[1]);
      const float wz = oz ? f[2] : __fsub_rn(1.f, f[2]);
      const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
      const uint32_t idx = row_index(clip(b[0] + ox, res_m1), clip(b[1] + oy, res_m1),
                                     clip(b[2] + oz, res_m1), lv.res[l], dense,
                                     lv.hash_mask) + off;
      Row<F>::add(table, idx, w, acc);
    }
  }

  float* o = out + t * F;  // out[s, l * F + f], since t = s * L + l
#pragma unroll
  for (int i = 0; i < F; ++i) o[i] = acc[i];
}

template <int F>
cudaError_t launch_f(const float* pos, const float* table, float* out, int64_t n, int L,
                     const Levels& lv, bool tetra, cudaStream_t stream) {
  const int64_t threads = n * L;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (tetra)
    hash_encode_fwd_kernel<F, true><<<blocks, kThreads, 0, stream>>>(pos, table, out, n, L, lv);
  else
    hash_encode_fwd_kernel<F, false><<<blocks, kThreads, 0, stream>>>(pos, table, out, n, L, lv);
  return cudaGetLastError();
}

}  // namespace

// pos: (n, 3) f32 in [0, 1]; table: (rows, F) f32; out: (n, L * F) f32.
// scales/res/offsets/dense: per-level host arrays of length L.
// Returns a cudaError_t.
extern "C" int umhs_hash_encode_fwd(const float* pos, const float* table, float* out,
                                    int64_t n, int L, int F, const float* scales,
                                    const int* res, const int* offsets, const int* dense,
                                    int log2_hashmap_size, int tetrahedral, void* stream) {
  if (L < 1 || L > kMaxLevels || n < 0 || log2_hashmap_size < 1 || log2_hashmap_size > 31)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Levels lv{};
  for (int l = 0; l < L; ++l) {
    lv.scale[l] = scales[l];
    lv.res[l] = res[l];
    lv.offset[l] = offsets[l];
    lv.dense[l] = dense[l];
  }
  lv.hash_mask = (1u << log2_hashmap_size) - 1u;
  auto s = static_cast<cudaStream_t>(stream);
  const bool tetra = tetrahedral != 0;
  switch (F) {
    case 1: return launch_f<1>(pos, table, out, n, L, lv, tetra, s);
    case 2: return launch_f<2>(pos, table, out, n, L, lv, tetra, s);
    case 4: return launch_f<4>(pos, table, out, n, L, lv, tetra, s);
    case 8: return launch_f<8>(pos, table, out, n, L, lv, tetra, s);
    default: return cudaErrorInvalidValue;
  }
}
