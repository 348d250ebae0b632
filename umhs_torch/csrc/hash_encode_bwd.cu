// K4: multi-resolution hash-grid encode, backward.
//
// Replaces umhs_tpu/ops/encodings.py::_hash_encode_bwd (lines 501-583, the
// custom VJP of _hash_encode_impl). On the TPU that is XLA scatter-adds laid
// out by hand; this kernel plays the role tiny-cuda-nn's HashGrid backward
// had in the original system.
//
// What it adds, into the zeroed f32 gradient table grad[row * F + f], for
// each (sample, level): the vertex rows and weights come from
// umhs::hash_vertices (hash_grid.cuh, the same function K3 gathers with), and
// - deterministic: w_v * g[s, l * F + f] goes to each of the V vertices;
// - stochastic: g itself goes to one vertex, drawn with probability w_v (an
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
// What bounds it on an H100: the reductions, each a read-modify-write of one
// 32-byte sector in L2 (the 48.8 MB table at L16xF2 2^19 nearly fits the
// 50 MB L2), and the zeroing of the table by the wrapper. Same-row
// reductions queue on one address.
//
// What this design does about it:
// - One thread per sample, looping over the L levels: the position is loaded
//   and the position hash u computed once per sample, not once per level. A
//   warp holds 32 consecutive samples at the same level; the compact buffer
//   is ray-major, so these are neighbours along one ray. Warp w starts at
//   level w mod L and wraps around: were every warp at level 0 together,
//   all the reductions in flight would queue on its 4,096 rows.
// - One vector reduction per (sample, level, vertex): F = 2 is one
//   atomicAdd(float2*) (REDG.F32x2, compute capability 9.x), F = 4 one
//   float4, F = 8 two, F = 1 a scalar. At F = 2 this halves the sector
//   operations of one scalar atomic per feature. g comes in one vector load
//   per level; a lane's 128-byte row of g stays in L1 across the levels.
// - On a dense level (uniform across the warp) the lanes that hit one row
//   are grouped with __match_any_sync, each group's values are summed in
//   lane order and its lowest lane issues the one reduction: neighbouring
//   samples of a ray share rows at the coarse levels, and their atomics no
//   longer queue there. Hashed levels skip this. The mask is the warp's
//   active lanes, so a tail warp takes part with the lanes it has.
// - A reduction whose values are all zero is not issued. In a training step
//   before the first adapt most of the 262,144-row compact buffer is
//   padding, every row at one position with a zero gradient; their
//   reductions would all queue on one row per level.
//
// The adds are float atomics, so their order, and the result's last bits
// where rows repeat, change from run to run.
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

__device__ __forceinline__ float position_uniform(const float p[3]) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(p[0], 12.9898f), __fmul_rn(p[1], 78.233f)),
                              __fmul_rn(p[2], 37.719f));
  return frac1(__fmul_rn(sinf(dot), 43758.5453f));
}

__device__ __forceinline__ float level_uniform(float u, int l) {
  return frac1(__fadd_rn(u, __fmul_rn(static_cast<float>(l), 0.6180339887f)));
}

// The F gradients of one (sample, level), in one or two vector loads.
template <int F>
__device__ __forceinline__ void load_row(const float* p, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(p);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  }
}

// One vector reduction into the table's row (F = 8: two).
template <int F>
__device__ __forceinline__ void reduce_row(float* grad, uint32_t row, const float (&v)[F]) {
  float* p = grad + static_cast<size_t>(row) * F;
  if constexpr (F == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < F / 4; ++i)
      atomicAdd(reinterpret_cast<float4*>(p) + i,
                make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
  }
}

// Adds v into `row`. With `aggregate` (uniform across the warp), the lanes of
// `mask` that share a row sum their values in lane order into the group's
// lowest lane, which alone issues the reduction. Every lane of `mask` must
// call this together. A reduction of zeros is skipped: it changes no entry
// (the table starts at +0, and +0 + -0 is +0), and the compact buffer's
// padding rows, all at one position, carry zero gradients.
template <int F>
__device__ __forceinline__ void add_row(float* grad, uint32_t row, float (&v)[F], bool aggregate,
                                        unsigned mask) {
  if (aggregate) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned group = __match_any_sync(mask, row);
    const bool leader = (group & ((1u << lane) - 1u)) == 0u;
    unsigned todo = leader ? group & (group - 1u) : 0u;  // the group's other lanes
    while (__any_sync(mask, todo != 0u)) {
      const int src = todo != 0u ? __ffs(todo) - 1 : static_cast<int>(lane);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float o = __shfl_sync(mask, v[f], src);
        if (todo != 0u) v[f] = __fadd_rn(v[f], o);
      }
      todo &= todo - 1u;
    }
    if (!leader) return;
  }
  bool zero = true;
#pragma unroll
  for (int f = 0; f < F; ++f) zero = zero && v[f] == 0.f;
  if (!zero) reduce_row<F>(grad, row, v);
}

template <int F, bool kTetra, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
hash_encode_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ g,
                       float* __restrict__ grad, int64_t n, int L, Levels lv) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const unsigned mask = __ballot_sync(0xffffffffu, s < n);
  if (s >= n) return;
  const float p[3] = {__ldg(pos + 3 * s), __ldg(pos + 3 * s + 1), __ldg(pos + 3 * s + 2)};
  const float u = kStochastic ? position_uniform(p) : 0.f;
  const float* gs = g + s * L * F;  // g[s, l * F + f]
  constexpr int V = kTetra ? 4 : 8;
  // Each warp starts at its own level, so the reductions in flight at one
  // moment spread over all levels instead of queueing on one level's rows.
  const int first = static_cast<int>((s >> 5) % L);
  for (int i = 0, l = first; i < L; ++i, l = l + 1 == L ? 0 : l + 1) {
    uint32_t rows[V];
    float w[V];
    umhs::hash_vertices<kTetra>(p, l, lv, rows, w);
    float gv[F];
    load_row<F>(gs + l * F, gv);
    const bool dense = lv.dense[l] != 0;
    if (kStochastic) {
      const float ul = level_uniform(u, l);
      uint32_t row = rows[V - 1];
      bool found = false;
      float cum = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        cum = v == 0 ? w[0] : __fadd_rn(cum, w[v]);
        if (!found && ul < cum) {
          row = rows[v];
          found = true;
        }
      }
      add_row<F>(grad, row, gv, dense, mask);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float c[F];
#pragma unroll
        for (int f = 0; f < F; ++f) c[f] = __fmul_rn(w[v], gv[f]);
        add_row<F>(grad, rows[v], c, dense, mask);
      }
    }
  }
}

template <int F, bool kTetra>
cudaError_t launch_tv(const float* pos, const float* g, float* grad, int64_t n, int L,
                      const Levels& lv, bool stochastic, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
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
// output, aligned to 4 * F bytes; grad: (rows * F,) f32, aligned to 4 * F
// bytes, zeroed by the caller, accumulated into. scales/res/offsets/dense:
// per-level host arrays of length L. Returns a cudaError_t.
extern "C" int umhs_hash_encode_bwd(const float* pos, const float* g, float* grad,
                                    int64_t n, int L, int F, const float* scales,
                                    const int* res, const int* offsets, const int* dense,
                                    int log2_hashmap_size, int tetrahedral, int stochastic,
                                    void* stream) {
  Levels lv;
  if (n < 0 || (F != 1 && F != 2 && F != 4 && F != 8) ||
      !umhs::fill_levels(lv, L, scales, res, offsets, dense, log2_hashmap_size))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(g) % (4 * F) != 0 ||
      reinterpret_cast<uintptr_t>(grad) % (4 * F) != 0)
    return cudaErrorMisalignedAddress;
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
