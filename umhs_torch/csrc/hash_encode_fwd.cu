// K3: multi-resolution hash-grid encode, forward.
//
// Replaces the forward of umhs_tpu/ops/encodings.py::_hash_encode_impl
// (lines 339-486: _lane_iw_tetra, _lane_indices_weights, _hash_lane_index,
// then one row gather and a per-level reduction). On the TPU that is XLA laid
// out by hand; this kernel plays the role tiny-cuda-nn's HashGrid had in the
// original system.
//
// One thread per (sample, level): the vertex rows and weights come from
// umhs::hash_vertices (hash_grid.cuh, shared with K4's backward). Each row's
// F features come in one vector load and sum_v w_v * row_v is accumulated in
// f32 into out[n, l * F + f].
//
// What bounds it on an H100: random row gathers. At L16xF2 2^19 the table is
// 48.8 MB, which nearly fits the 50 MB L2; each vertex touches one 32-byte
// sector for 8 useful bytes. Threads of one sample sit next to each other so
// the position loads are shared and the output row is written contiguously.
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
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * L) return;
  const int64_t s = t / L;
  const int l = static_cast<int>(t - s * L);
  const float p[3] = {__ldg(pos + 3 * s), __ldg(pos + 3 * s + 1), __ldg(pos + 3 * s + 2)};
  constexpr int V = kTetra ? 4 : 8;
  uint32_t rows[V];
  float w[V];
  umhs::hash_vertices<kTetra>(p, l, lv, rows, w);
  float acc[F];
#pragma unroll
  for (int i = 0; i < F; ++i) acc[i] = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) Row<F>::add(table, rows[v], w[v], acc);

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
  Levels lv;
  if (n < 0 || !umhs::fill_levels(lv, L, scales, res, offsets, dense, log2_hashmap_size))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
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
