// K4: multi-resolution hash-grid encode, backward.
//
// Replaces umhs_tpu/ops/encodings.py::_hash_encode_bwd (lines 501-583, the
// custom VJP of _hash_encode_impl). On the TPU that is XLA scatter-adds laid
// out by hand; this kernel plays the role tiny-cuda-nn's HashGrid backward
// had in the original system.
//
// One thread per (sample, level). It recomputes the vertex rows and weights
// with umhs::hash_vertices (hash_grid.cuh, the same function K3 gathers
// with) and adds into the zeroed f32 gradient table, grad[row * F + f]:
// - deterministic: w_v * g[s, l * F + f] for each of the V vertices;
// - stochastic: g itself for one vertex, drawn with probability w_v (an
//   unbiased estimate with V times fewer adds). The uniform variate is the
//   position hash of encodings.py:529-536: u = frac(sin(p . c) * 43758.5453)
//   with c = (12.9898, 78.233, 37.719), the dot taken as ((x c0 + y c1) +
//   z c2) with every product and sum rounded (no FMA), precise sinf (this
//   source is built without --use_fast_math), then u_l = frac(u + l *
//   0.6180339887). The vertex is the first v with u_l < w_0 + ... + w_v
//   (running f32 sums), else the last: exactly one vertex per (sample,
//   level). frac is torch.remainder(., 1), so the plain version
//   (umhs_torch/ops/encodings.py) computes the same bits.
//
// The adds are float atomicAdds, so their order, and the result's last bits
// where rows repeat, change from run to run.
//
// What bounds it on an H100: the zeroing of the gradient table (48.8 MB at
// L16xF2 2^19, by the wrapper) and the random read-modify-write of one
// 32-byte sector per vertex row; the table nearly fits the 50 MB L2, so the
// atomics resolve there.
#include <stdint.h>

#include "common.cuh"
#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;
using umhs::Levels;

// torch.remainder(v, 1.f): fmod, shifted into [0, 1) for negative v.
__device__ __forceinline__ float frac1(float v) {
  float r = fmodf(v, 1.f);
  if (r != 0.f && r < 0.f) r += 1.f;
  return r;
}

__device__ __forceinline__ float level_uniform(const float p[3], int l) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(p[0], 12.9898f), __fmul_rn(p[1], 78.233f)),
                              __fmul_rn(p[2], 37.719f));
  const float u = frac1(__fmul_rn(sinf(dot), 43758.5453f));
  return frac1(__fadd_rn(u, __fmul_rn(static_cast<float>(l), 0.6180339887f)));
}

template <int F, bool kTetra, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ g,
                       float* __restrict__ grad, int64_t n, int L, Levels lv) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n * L) return;
  const int64_t s = t / L;
  const int l = static_cast<int>(t - s * L);
  const float p[3] = {__ldg(pos + 3 * s), __ldg(pos + 3 * s + 1), __ldg(pos + 3 * s + 2)};
  constexpr int V = kTetra ? 4 : 8;
  uint32_t rows[V];
  float w[V];
  umhs::hash_vertices<kTetra>(p, l, lv, rows, w);
  float gv[F];
#pragma unroll
  for (int f = 0; f < F; ++f) gv[f] = __ldg(g + t * F + f);  // g[s, l * F + f]

  if (kStochastic) {
    const float u = level_uniform(p, l);
    uint32_t row = rows[V - 1];
    bool found = false;
    float cum = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      cum = v == 0 ? w[0] : __fadd_rn(cum, w[v]);
      if (!found && u < cum) {
        row = rows[v];
        found = true;
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(grad + static_cast<size_t>(row) * F + f, gv[f]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int f = 0; f < F; ++f)
        atomicAdd(grad + static_cast<size_t>(rows[v]) * F + f, __fmul_rn(w[v], gv[f]));
  }
}

template <int F, bool kTetra>
cudaError_t launch_tv(const float* pos, const float* g, float* grad, int64_t n, int L,
                      const Levels& lv, bool stochastic, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n * L + kThreads - 1) / kThreads);
  if (stochastic)
    hash_encode_bwd_kernel<F, kTetra, true><<<blocks, kThreads, 0, stream>>>(pos, g, grad, n, L, lv);
  else
    hash_encode_bwd_kernel<F, kTetra, false><<<blocks, kThreads, 0, stream>>>(pos, g, grad, n, L, lv);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_f(const float* pos, const float* g, float* grad, int64_t n, int L,
                     const Levels& lv, bool tetra, bool stochastic, cudaStream_t stream) {
  return tetra ? launch_tv<F, true>(pos, g, grad, n, L, lv, stochastic, stream)
               : launch_tv<F, false>(pos, g, grad, n, L, lv, stochastic, stream);
}

}  // namespace

// pos: (n, 3) f32 in [0, 1]; g: (n, L * F) f32, the gradient of K3's
// output; grad: (rows * F,) f32, zeroed by the caller, accumulated into.
// scales/res/offsets/dense: per-level host arrays of length L.
// Returns a cudaError_t.
extern "C" int umhs_hash_encode_bwd(const float* pos, const float* g, float* grad,
                                    int64_t n, int L, int F, const float* scales,
                                    const int* res, const int* offsets, const int* dense,
                                    int log2_hashmap_size, int tetrahedral, int stochastic,
                                    void* stream) {
  Levels lv;
  if (n < 0 || !umhs::fill_levels(lv, L, scales, res, offsets, dense, log2_hashmap_size))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const bool tetra = tetrahedral != 0, stoch = stochastic != 0;
  switch (F) {
    case 1: return launch_f<1>(pos, g, grad, n, L, lv, tetra, stoch, s);
    case 2: return launch_f<2>(pos, g, grad, n, L, lv, tetra, stoch, s);
    case 4: return launch_f<4>(pos, g, grad, n, L, lv, tetra, stoch, s);
    case 8: return launch_f<8>(pos, g, grad, n, L, lv, tetra, stoch, s);
    default: return cudaErrorInvalidValue;
  }
}
