// K3: multi-resolution hash-grid encode, forward.
//
// Replaces the forward of umhs_tpu/ops/encodings.py::_hash_encode_impl
// (lines 339-486: _lane_iw_tetra, _lane_indices_weights, _hash_lane_index,
// then one row gather and a per-level reduction). On the TPU that is XLA laid
// out by hand; this kernel plays the role tiny-cuda-nn's HashGrid had in the
// original system.
//
// For each (sample, level) the vertex rows and weights come from
// umhs::hash_vertices (hash_grid.cuh, shared with K4's backward); each row's
// F features come in one vector load and sum_v w_v * row_v is accumulated in
// f32 into out[n, l * F + f].
//
// What bounds it on an H100: random row gathers, one 32-byte sector for
// 8 useful bytes per vertex at L16xF2 2^19 (48.8 MB of table against a 50 MB
// L2), at the rate the SMs keep sector reads in flight. Designs that walk the
// levels in step so that one level's slice of the table stays in L2 were
// slower (PERF.md, PR 6): fewer reads in flight per SM, or, with the level as
// the slow grid dimension, a partial-sector store per (sample, level).
//
// What this design does about it:
// - A block takes 32 samples and every level: warp w computes levels w,
//   w + 8, ..., two levels at a time with all their vertex reads issued
//   together, for the 32 samples, one a lane. A warp's lanes are
//   neighbouring samples at one level, so on ray-ordered input they share
//   the dense levels' rows in L1.
// - The output goes through a tile of 32 samples x L * F floats in shared
//   memory (rows padded by one float, so a warp's stores hit 32 banks) and
//   leaves as one contiguous run of coalesced words, stored with the
//   streaming hint (evict first): the output, 128 MB at 2^20 samples, then
//   displaces less of the table from L2.
//
// Those kernels are template instances for F 1, 2, 4 and 8 with the levels
// by value (at most 32). Every other shape (any F, any number of levels)
// takes hash_encode_fwd_any_kernel: the level arguments come from a device
// table (hash_grid.cuh's LevelArg), a (sample, level)'s V rows and weights
// stay in registers while its F features are summed 4 at a time by float4
// loads where F % 4 == 0 (the table's rows then 16-byte aligned), else one
// at a time, so registers do not grow with F; and the output goes
// through the tile a group of levels at a time (32 x (G F + 1) floats, G as
// many levels as fit 48 KB, or one level in up to 227 KB of dynamic shared
// memory; past that straight to out). Each output is the same fmaf chain
// over the vertices in order as the instances'. The launcher reports the
// route it took: 0 for the instances ("fixed"), 1 for this kernel ("any").
#include <stdint.h>

#include "common.cuh"
#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;
using umhs::Levels;

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

template <int F, bool kTetra>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                       float* __restrict__ out, int64_t n, int L, Levels lv) {
  extern __shared__ float tile[];  // 32 rows of L * F + 1 floats
  const int width = L * F, stride = width + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * 32;
  const int64_t s = first + lane;
  if (s < n) {
    const float p[3] = {__ldg(pos + 3 * s), __ldg(pos + 3 * s + 1), __ldg(pos + 3 * s + 2)};
    constexpr int V = kTetra ? 4 : 8;
    constexpr int kStep = kThreads / 32;
    for (int l = warp; l < L; l += 2 * kStep) {
      const int l1 = l + kStep < L ? l + kStep : l;
      uint32_t r0[V], r1[V];
      float w0[V], w1[V];
      umhs::hash_vertices<kTetra>(p, l, lv, r0, w0);
      umhs::hash_vertices<kTetra>(p, l1, lv, r1, w1);
      float a0[F], a1[F];
#pragma unroll
      for (int i = 0; i < F; ++i) a0[i] = a1[i] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) Row<F>::add(table, r0[v], w0[v], a0);
#pragma unroll
      for (int v = 0; v < V; ++v) Row<F>::add(table, r1[v], w1[v], a1);
#pragma unroll
      for (int i = 0; i < F; ++i) tile[lane * stride + l * F + i] = a0[i];
      if (l1 != l) {
#pragma unroll
        for (int i = 0; i < F; ++i) tile[lane * stride + l1 * F + i] = a1[i];
      }
    }
  }
  __syncthreads();
  const int rows_here = static_cast<int>(n - first < 32 ? n - first : 32);
  float* dst = out + first * width;
  const int count = rows_here * width;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int r = i / width;
    __stcs(dst + i, tile[r * stride + (i - r * width)]);
  }
}

template <int F>
cudaError_t launch_f(const float* pos, const float* table, float* out, int64_t n, int L,
                     const Levels& lv, bool tetra, cudaStream_t stream) {
  const size_t shared = static_cast<size_t>(32) * (L * F + 1) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
  if (tetra)
    hash_encode_fwd_kernel<F, true><<<blocks, kThreads, shared, stream>>>(pos, table, out, n, L, lv);
  else
    hash_encode_fwd_kernel<F, false><<<blocks, kThreads, shared, stream>>>(pos, table, out, n, L, lv);
  return cudaGetLastError();
}

constexpr int kAnyTileBytes = 48 * 1024;  // the tile without the dynamic attribute
constexpr int kSmemMax = 232448;  // bytes a block may use on sm_90

template <bool kTetra>
__global__ void __launch_bounds__(kThreads)
hash_encode_fwd_any_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                           float* __restrict__ out, int64_t n, int L, int F,
                           const umhs::LevelArg* __restrict__ levels, uint32_t hash_mask,
                           int group, int staged) {
  extern __shared__ float tile[];  // 32 rows of group * F + 1 floats (when staged)
  constexpr int V = kTetra ? 4 : 8;
  constexpr int kWarps = kThreads / 32;
  const int64_t width = static_cast<int64_t>(L) * F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * 32;
  const int64_t s = first + lane;
  const bool vec = F % 4 == 0;
  float p[3] = {0.f, 0.f, 0.f};
  if (s < n) {
    p[0] = __ldg(pos + 3 * s);
    p[1] = __ldg(pos + 3 * s + 1);
    p[2] = __ldg(pos + 3 * s + 2);
  }
  const int rows_here = static_cast<int>(n - first < 32 ? n - first : 32);
  for (int g0 = 0; g0 < L; g0 += group) {
    const int g1 = g0 + group < L ? g0 + group : L;
    const int cols = (g1 - g0) * F, stride = cols + 1;
    if (s < n) {
      for (int l = g0 + warp; l < g1; l += kWarps) {
        uint32_t rows[V];
        float w[V];
        umhs::hash_vertices<kTetra>(p, umhs::level_arg(levels, l), hash_mask, rows, w);
        float* dst = staged ? tile + lane * stride + (l - g0) * F : out + s * width + l * F;
        if (vec) {  // 16-byte rows: 4 features a load
          for (int f0 = 0; f0 < F; f0 += 4) {
            float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float4 t =
                  __ldg(reinterpret_cast<const float4*>(table + static_cast<size_t>(rows[v]) * F + f0));
              acc.x = fmaf(w[v], t.x, acc.x);
              acc.y = fmaf(w[v], t.y, acc.y);
              acc.z = fmaf(w[v], t.z, acc.z);
              acc.w = fmaf(w[v], t.w, acc.w);
            }
            dst[f0] = acc.x;
            dst[f0 + 1] = acc.y;
            dst[f0 + 2] = acc.z;
            dst[f0 + 3] = acc.w;
          }
        } else {  // a feature at a time
          for (int f = 0; f < F; ++f) {
            float acc = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc = fmaf(w[v], __ldg(table + static_cast<size_t>(rows[v]) * F + f), acc);
            dst[f] = acc;
          }
        }
      }
    }
    if (!staged) continue;
    __syncthreads();
    const int count = rows_here * cols;
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const int r = i / cols;
      __stcs(out + (first + r) * width + static_cast<int64_t>(g0) * F + (i - r * cols),
             tile[r * stride + (i - r * cols)]);
    }
    __syncthreads();  // the tile serves the next group
  }
}

// Levels per group of the any kernel's tile, and its shared-memory bytes
// (0 when not even one level's tile fits: straight to out).
void any_group(int L, int F, int& group, size_t& shared) {
  const size_t per_row = kAnyTileBytes / (32 * sizeof(float));
  group = static_cast<int>((per_row - 1) / static_cast<size_t>(F));
  if (group >= 1) {
    group = group < L ? group : L;
  } else {
    group = 1;
  }
  shared = static_cast<size_t>(32) * (static_cast<size_t>(group) * F + 1) * sizeof(float);
  if (shared > static_cast<size_t>(kSmemMax)) shared = 0;
}

template <bool kTetra>
cudaError_t launch_any(const float* pos, const float* table, float* out, int64_t n, int L, int F,
                       const umhs::LevelArg* levels, uint32_t hash_mask, cudaStream_t stream) {
  int group = 0;
  size_t shared = 0;
  any_group(L, F, group, shared);
  auto kernel = hash_encode_fwd_any_kernel<kTetra>;
  if (shared > static_cast<size_t>(kAnyTileBytes)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = static_cast<unsigned>((n + 31) / 32);
  kernel<<<blocks, kThreads, shared, stream>>>(pos, table, out, n, L, F, levels, hash_mask,
                                               shared ? group : L, shared != 0);
  return cudaGetLastError();
}

}  // namespace

// pos: (n, 3) f32 in [0, 1]; table: (rows, F) f32; out: (n, L * F) f32.
// scales/res/offsets/dense: per-level host arrays of length L; level_table:
// the same as L LevelArg on the device (read by the any kernel). Writes the
// route it took to *route (0 the instances, 1 the any kernel). Returns a
// cudaError_t.
extern "C" int umhs_hash_encode_fwd(const float* pos, const float* table, float* out,
                                    int64_t n, int L, int F, const float* scales,
                                    const int* res, const int* offsets, const int* dense,
                                    int log2_hashmap_size, int tetrahedral,
                                    const void* level_table, void* stream, int32_t* route) {
  if (n < 0 || L < 1 || F < 1 || log2_hashmap_size < 1 || log2_hashmap_size > 31)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool tetra = tetrahedral != 0;
  if (!umhs::fixed_shape(L, F)) {
    if (level_table == nullptr || reinterpret_cast<uintptr_t>(level_table) % 16 != 0)
      return cudaErrorInvalidValue;
    *route = 1;
    if (n == 0) return cudaSuccess;
    const uint32_t mask = (1u << log2_hashmap_size) - 1u;
    const auto* levels = static_cast<const umhs::LevelArg*>(level_table);
    return tetra ? launch_any<true>(pos, table, out, n, L, F, levels, mask, s)
                 : launch_any<false>(pos, table, out, n, L, F, levels, mask, s);
  }
  Levels lv;
  if (!umhs::fill_levels(lv, L, scales, res, offsets, dense, log2_hashmap_size))
    return cudaErrorInvalidValue;
  *route = 0;
  if (n == 0) return cudaSuccess;
  switch (F) {
    case 1: return launch_f<1>(pos, table, out, n, L, lv, tetra, s);
    case 2: return launch_f<2>(pos, table, out, n, L, lv, tetra, s);
    case 4: return launch_f<4>(pos, table, out, n, L, lv, tetra, s);
    case 8: return launch_f<8>(pos, table, out, n, L, lv, tetra, s);
    default: return cudaErrorInvalidValue;
  }
}
