// K6c and K6d: volume-rendering weights and the per-ray sums over the compact
// buffer, forward and backward.
//
// K6c replaces umhs_tpu/ops/compositing.py::render_weights (lines 34-73), and
// K6d replaces segment_accumulate (lines 84-115) with the gather of the
// weights through `src` (umhs_tpu/models/model.py:520-549) folded in. Both
// are XLA on the TPU; in the original system nerfacc's
// render_weight_from_density and accumulate_along_rays did this work.
//
// K6c, on (R, S) lanes, one warp a ray, the lanes in chunks of 32:
//   delta = max(t_end - t_start, 0); x = mask ? sigma * delta : 0;
//   a = 1 - exp(-x); keep = mask && a >= alpha_thre (every lane when the
//   filter is off); x' = keep ? x : 0; c = the exclusive scan of x';
//   T = exp(-c); alive = T >= eps (every lane when eps <= 0);
//   w = (keep && alive ? a : 0) * T.
// The scan runs in the warp with shuffles, chunk after chunk with a carry.
// Its backward loads a ray's inputs and g at once (its chunk count a
// template parameter: 1, 2, 4 or 8 for S <= 32, 64, 128, 256), recomputes
// the forward with the same shuffle trees and carries (each chunk's tree on
// its own, side by side, then the carries in chunk order), then takes the
// exclusive suffix sum of g * w the same way from the last chunk down:
//   dx = keep ? (alive ? g * T * exp(-x) : 0) - sum_{j > i} g_j w_j : 0,
//   dsigma = mask ? dx * delta : 0, ddelta = mask ? dx * sigma : 0, passed
//   where t_end - t_start >= 0 (torch's clamp_min), to t_end and -t_start.
// The forward takes any S, writing each chunk as it goes. Past 256 lanes a
// ray (S > kChunks * 32) the backward takes a kernel of its own, with the
// same chunks, trees and carry order: it runs a ray in groups of kChunks
// chunks, a first sweep keeping the forward's carry at each group's first
// chunk (a float a group, in a scratch row the wrapper allocates), then the
// groups from the last down, each loaded at once and run as a short ray
// is, from its kept carry and the suffix sum of g * w over the later
// groups. It reads the inputs twice, the price of an unbounded ray in a
// warp's registers.
//
// K6d forward, one launch for one head over every stage of the compact
// buffer: out[r, c] = sum over the stages k, in stage order, of s_k[r, c],
// where s_k[r, c] is the sum over ray r's run of rows b in [starts_k[r],
// starts_k[r] + counts_k[r]) of w[r, lo_k + src_k[b] - r * L_k] * h_k[b, c],
// taken in ascending b with fmaf from +0; the stage sums are added with
// __fadd_rn. That is what a launch per stage followed by PyTorch's adds of
// the stage outputs computes, bit for bit, with one write of out and no
// per-stage (R, C) arrays. Its backward, a launch per stage, a warp a row:
// for b < total, dh[b, c] = w[src[b]] * g[ray(b), c] and
// dw[src[b]] = sum_c h[b, c] * g[ray(b), c] (a store to a lane no other row
// writes, at the stage's columns of one (R, S) dw the caller zeroes), with
// ray(b) = src[b] / L; rows past total get dh = 0 and write nothing else.
// h is f32 or bf16; sums are f32.
//
// No atomics anywhere: each output is written by one thread and every sum
// is taken in a fixed order, so every run gives the same bits.
//
// What bounds them on an H100: bytes. K6c reads four (R, S) inputs and
// writes one (its backward reads five, once, and writes up to three). K6d's
// forward reads each stage's rows once (C values, src, the weight) with
// its starts and counts, and writes (R, C) once. Its design: a group of G
// lanes a ray (G = 32 for heads wider than 64 channels, fewer for narrow
// heads, so a warp holds several rays of a 6-wide head), each lane four
// consecutive channels, in float4 (f32) or 8-byte (4 x bf16) loads where a
// stage's rows are aligned and a scalar route in the same kernel where they
// are not. The lanes load a run's src and weights a lane a row and hand
// them round by shuffle; the rows are unrolled by four, so four rows'
// loads are in flight per lane.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace umhs {

constexpr int kMaxStages = 8;  // stages a K6d forward launch takes

// One stage of a head for K6d's forward. Mirrors umhs_torch/ops/
// compositing.py's SegmentStage field for field.
struct SegmentStage {
  const int64_t* src;     // (Bs,) the flat lane of each row
  const int64_t* starts;  // (R,) each ray's first row
  const int64_t* counts;  // (R,) each ray's rows
  const void* h;          // (Bs, C) f32 or bf16, row stride h_stride
  int64_t h_stride;       // elements
  int32_t lo;             // the stage's first column in the (R, S) weights
  int32_t L;              // its lanes a ray
  int32_t vec;            // 1: every row's channels 4-aligned (16 bytes f32, 8 bf16)
  int32_t pad;
};

struct SegmentStages {
  SegmentStage stage[kMaxStages];
};

}  // namespace umhs

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;      // rays (K6c) or rows (K6d's backward) per block
constexpr int kChunks = 8;     // K6c's backward: S <= kChunks * 32 in one go, longer rays in groups
constexpr int kMaxLanes = 0x7fffffff - 32;  // K6c: a lane index s0 + lane stays an int32
constexpr int kThreads = 256;  // K6d's forward

struct RayInputs {
  const float* ts;
  const float* te;
  const float* sigma;
  const uint8_t* mask;
  int64_t ts_stride, te_stride, sigma_stride, mask_stride;
  int32_t R, S;
  const float* thre_ptr;  // the alpha threshold on the device, or null
  float thre_val;         // the threshold when thre_ptr is null
  int32_t use_thre;       // 0: no alpha filter
  float eps;              // the early-stop filter when > 0
};

// One lane's values: the forward's, with e = exp(-x) kept for the backward
// and t_end - t_start >= 0 (where clamp_min passes the gradient).
struct Lane {
  float delta, sigma, x, a, T, e;
  bool on, keep, alive, ordered;
};

// A lane's values before the scan, from its loads (in_row: s < S).
__device__ __forceinline__ void lane_start(Lane& v, bool in_row, float ts, float te,
                                           float sigma, uint8_t m, int32_t use_thre,
                                           float thre) {
  v.on = in_row && m != 0;
  v.delta = 0.0f;
  v.sigma = 0.0f;
  v.x = 0.0f;
  v.ordered = false;
  if (in_row) {
    const float diff = te - ts;
    v.delta = fmaxf(diff, 0.0f);
    v.ordered = diff >= 0.0f;
    v.sigma = sigma;
    if (v.on) v.x = __fmul_rn(v.sigma, v.delta);
  }
  v.e = expf(-v.x);
  v.a = 1.0f - v.e;
  v.keep = use_thre ? (v.on && v.a >= thre) : true;
}

// A lane's transmittance from its exclusive optical depth c.
__device__ __forceinline__ void lane_finish(Lane& v, float c, float eps) {
  v.T = expf(-c);
  v.alive = eps <= 0.0f || v.T >= eps;
}

__device__ __forceinline__ float warp_exclusive_scan(float v, int lane, float* chunk_total) {
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  *chunk_total = __shfl_sync(kFull, incl, 31);
  const float excl = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.0f : excl;
}

__device__ __forceinline__ float warp_exclusive_suffix(float v, int lane, float* chunk_total) {
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += y;
  }
  *chunk_total = __shfl_sync(kFull, incl, 0);
  const float excl = __shfl_down_sync(kFull, incl, 1);
  return lane == 31 ? 0.0f : excl;
}

__device__ __forceinline__ float alpha_threshold(const RayInputs& in) {
  return in.use_thre ? (in.thre_ptr ? *in.thre_ptr : in.thre_val) : 0.0f;
}

__device__ __forceinline__ float lane_weight(const Lane& v) {
  return __fmul_rn(v.keep && v.alive ? v.a : 0.0f, v.T);
}

// K6c backward: one ray's inputs, NC chunks of 32 lanes, loaded at once.
template <int NC>
struct RayLoads {
  float ts[NC], te[NC], sigma[NC], g[NC];
  uint8_t m[NC];
};

// g: (R, S) contiguous. Every load of ray r's lanes [base, base + 32 NC)
// in one go (0 past S).
template <int NC>
__device__ __forceinline__ void load_ray(const RayInputs& in, const float* __restrict__ g,
                                         int64_t r, int lane, RayLoads<NC>& v, int base = 0) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int s = base + k * 32 + lane;
    const bool in_row = s < in.S;
    v.ts[k] = in_row ? in.ts[r * in.ts_stride + s] : 0.0f;
    v.te[k] = in_row ? in.te[r * in.te_stride + s] : 0.0f;
    v.sigma[k] = in_row ? in.sigma[r * in.sigma_stride + s] : 0.0f;
    v.m[k] = in_row ? in.mask[r * in.mask_stride + s] : 0;
    v.g[k] = in_row ? g[r * in.S + s] : 0.0f;
  }
}

// The backward of ray r's lanes [base, base + 32 NC) from their loads (S
// <= 32 * NC for a whole ray, base 0). The forward is recomputed as
// render_weights_fwd_kernel computes it: each chunk's scan by the same tree
// (the chunks' trees are independent, so they run side by side), then the
// carries added in chunk order from `carry0`, the forward's carry at lane
// `base`. The suffix sums of g * w likewise: each chunk's tree, then the
// carries from the last chunk down, from *after_io (the sum over the lanes
// past these) when given, which gets the sum past `base`; a chunk at or
// past S takes no part, as the forward never reaches it.
template <int NC>
__device__ __forceinline__ void backward_ray(const RayInputs& in, float thre,
                                             const RayLoads<NC>& v, int64_t r, int lane,
                                             float* __restrict__ dsigma, float* __restrict__ dts,
                                             float* __restrict__ dte, int base = 0,
                                             float carry0 = 0.0f, float* after_io = nullptr) {
  Lane L[NC];
  float excl[NC], total[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    lane_start(L[k], base + k * 32 + lane < in.S, v.ts[k], v.te[k], v.sigma[k], v.m[k],
               in.use_thre, thre);
    excl[k] = warp_exclusive_scan(L[k].keep ? L[k].x : 0.0f, lane, &total[k]);
  }
  float carry = carry0;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    lane_finish(L[k], carry + excl[k], in.eps);
    carry += total[k];
  }
  float after_excl[NC], after_total[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k)
    after_excl[k] = warp_exclusive_suffix(__fmul_rn(v.g[k], lane_weight(L[k])), lane,
                                          &after_total[k]);
  float after = after_io ? *after_io : 0.0f;  // sum of g * w over the chunks past this one
#pragma unroll
  for (int k = NC - 1; k >= 0; --k) {
    if (base + k * 32 >= in.S) continue;  // uniform over the warp
    const float later = after + after_excl[k];
    after += after_total[k];
    const int s = base + k * 32 + lane;
    if (s >= in.S) continue;
    const Lane& u = L[k];
    float dx = 0.0f;
    if (u.keep) {
      const float direct = u.alive ? __fmul_rn(__fmul_rn(v.g[k], u.T), u.e) : 0.0f;
      dx = direct - later;
    }
    const int64_t o = r * in.S + s;
    const float dx_on = u.on ? dx : 0.0f;
    if (dsigma) dsigma[o] = __fmul_rn(dx_on, u.delta);
    if (dts || dte) {
      const float dd = u.ordered ? __fmul_rn(dx_on, u.sigma) : 0.0f;
      if (dte) dte[o] = dd;
      if (dts) dts[o] = -dd;
    }
  }
  if (after_io) *after_io = after;
}

// dsigma, dts, dte: (R, S) contiguous, each null when not wanted. A warp a
// ray, kWarps rays a block.
template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
render_weights_bwd_kernel(RayInputs in, const float* __restrict__ g, float* __restrict__ dsigma,
                          float* __restrict__ dts, float* __restrict__ dte) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= in.R) return;  // uniform over the warp
  RayLoads<NC> v;
  load_ray(in, g, r, lane, v);
  backward_ray(in, alpha_threshold(in), v, r, lane, dsigma, dts, dte);
}

// Lane s of ray r loaded (0 past S) and started.
__device__ __forceinline__ void load_lane(const RayInputs& in, int64_t r, int s, float thre,
                                          Lane& v) {
  const bool in_row = s < in.S;
  lane_start(v, in_row, in_row ? in.ts[r * in.ts_stride + s] : 0.0f,
             in_row ? in.te[r * in.te_stride + s] : 0.0f,
             in_row ? in.sigma[r * in.sigma_stride + s] : 0.0f,
             in_row ? in.mask[r * in.mask_stride + s] : 0, in.use_thre, thre);
}

// K6c forward, a warp a ray at any S: chunk after chunk, each chunk's scan
// by warp_exclusive_scan's tree and the carry added in chunk order, its
// weights written as it is done. K6c's backward recomputes it with the same
// lane_start, tree, carry order and lane_finish.
__global__ void __launch_bounds__(kWarps * 32)
render_weights_fwd_kernel(RayInputs in, float* __restrict__ w) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= in.R) return;  // uniform over the warp
  const float thre = alpha_threshold(in);
  float carry = 0.0f;
  for (int s0 = 0; s0 < in.S; s0 += 32) {  // uniform over the warp
    const int s = s0 + lane;
    Lane v;
    load_lane(in, r, s, thre, v);
    float chunk_total;
    const float c = carry + warp_exclusive_scan(v.keep ? v.x : 0.0f, lane, &chunk_total);
    carry += chunk_total;
    lane_finish(v, c, in.eps);
    if (s < in.S) w[r * in.S + s] = lane_weight(v);
  }
}

// K6c backward past kChunks * 32 lanes, a warp a ray: carries (R, groups)
// f32 scratch, groups = ceil(S / (kChunks * 32)). The first sweep is the
// forward's scan, chunk by chunk (lane_start and the same tree), keeping
// the carry at each group's first chunk; then each group from the last
// down runs as backward_ray<kChunks> from its kept carry, the suffix sum
// carried across groups.
__global__ void __launch_bounds__(kWarps * 32)
render_weights_bwd_long_kernel(RayInputs in, const float* __restrict__ g,
                               float* __restrict__ carries, float* __restrict__ dsigma,
                               float* __restrict__ dts, float* __restrict__ dte) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= in.R) return;  // uniform over the warp
  constexpr int kGroup = kChunks * 32;
  const float thre = alpha_threshold(in);
  const int groups = (in.S + kGroup - 1) / kGroup;
  float* kept = carries + r * groups;
  float carry = 0.0f;
  for (int s0 = 0; s0 < in.S; s0 += 32) {  // uniform over the warp
    if (s0 % kGroup == 0 && lane == 0) kept[s0 / kGroup] = carry;
    Lane v;
    load_lane(in, r, s0 + lane, thre, v);
    float chunk_total;
    warp_exclusive_scan(v.keep ? v.x : 0.0f, lane, &chunk_total);
    carry += chunk_total;
  }
  __syncwarp();  // lane 0's kept carries, to every lane
  float after = 0.0f;
  for (int q = groups - 1; q >= 0; --q) {
    RayLoads<kChunks> v;
    load_ray(in, g, r, lane, v, q * kGroup);
    backward_ray(in, thre, v, r, lane, dsigma, dts, dte, q * kGroup, kept[q], &after);
  }
}

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T store(float v);
template <>
__device__ __forceinline__ float store<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// K6d's backward: one stage.
struct Segments {
  const float* w;  // the stage's (R, L) weights, row stride w_stride
  int64_t w_stride;
  int32_t L;
  const int64_t* src;     // (Bs,)
  const int32_t* total;   // (1,)
  int64_t h_stride;       // the heads' row stride (elements)
  int64_t dw_stride;      // dw's row stride (elements)
  int32_t R, C, Bs;
};

// The weight of flat lane f (< R * L < 2^31: 32-bit division).
__device__ __forceinline__ float row_weight(const Segments& sg, int64_t f) {
  const int32_t r = static_cast<int32_t>(f) / sg.L, l = static_cast<int32_t>(f) % sg.L;
  return sg.w[static_cast<int64_t>(r) * sg.w_stride + l];
}

// Four channels c..c+3 of a row as loaded (0 past C): one vector load
// when the stage's rows are aligned, else scalar loads. bf16 stays packed
// (two 32-bit words) until the FMA, so four rows in flight take 8
// registers, not 16.
template <typename T>
struct Packed;
template <>
struct Packed<float> {
  using type = float4;
};
template <>
struct Packed<__nv_bfloat16> {
  using type = uint2;
};

template <typename T>
__device__ __forceinline__ typename Packed<T>::type load4(const T* row, int32_t c, int32_t C,
                                                          int32_t vec);
template <>
__device__ __forceinline__ float4 load4<float>(const float* row, int32_t c, int32_t C,
                                               int32_t vec) {
  if (vec) {
    if (c < C) return *reinterpret_cast<const float4*>(row + c);
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return make_float4(c < C ? row[c] : 0.0f, c + 1 < C ? row[c + 1] : 0.0f,
                     c + 2 < C ? row[c + 2] : 0.0f, c + 3 < C ? row[c + 3] : 0.0f);
}
template <>
__device__ __forceinline__ uint2 load4<__nv_bfloat16>(const __nv_bfloat16* row, int32_t c,
                                                      int32_t C, int32_t vec) {
  if (vec) {
    if (c < C) return *reinterpret_cast<const uint2*>(row + c);
    return make_uint2(0u, 0u);
  }
  const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
  const uint32_t b0 = c < C ? h[c] : 0u, b1 = c + 1 < C ? h[c + 1] : 0u;
  const uint32_t b2 = c + 2 < C ? h[c + 2] : 0u, b3 = c + 3 < C ? h[c + 3] : 0u;
  return make_uint2(b0 | b1 << 16, b2 | b3 << 16);
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// A bf16 is the high half of its f32: widen in registers.
__device__ __forceinline__ void fma4(float4& acc, float w, const uint2& x) {
  acc.x = fmaf(w, __uint_as_float(x.x << 16), acc.x);
  acc.y = fmaf(w, __uint_as_float(x.x & 0xffff0000u), acc.y);
  acc.z = fmaf(w, __uint_as_float(x.y << 16), acc.z);
  acc.w = fmaf(w, __uint_as_float(x.y & 0xffff0000u), acc.w);
}

// A group of G lanes (a power of two <= 32) takes ray r; lane gl of the
// group owns channels c0 + 4 gl .. + 3 of each chunk of 4 G channels. With
// `chain`, out already holds the sums of earlier stages (a head with more
// than kMaxStages stages takes several launches) and these stages add on.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_accumulate_fwd_kernel(const float* __restrict__ w, int64_t w_stride,
                              const __grid_constant__ umhs::SegmentStages stages,
                              int32_t n_stages, int32_t R, int32_t C, int32_t G, int32_t chain,
                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / G;
  if (r >= R) return;  // uniform over the group
  const float* w_ray = w + r * w_stride;
  float* out_ray = out + r * C;
  const bool vec_out = (C & 3) == 0;
  for (int32_t c0 = 0; c0 < C; c0 += 4 * G) {
    const int32_t c = c0 + 4 * gl;
    float4 tot = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (chain && c < C) {
      tot = vec_out ? *reinterpret_cast<const float4*>(out_ray + c)
                    : make_float4(out_ray[c], c + 1 < C ? out_ray[c + 1] : 0.0f,
                                  c + 2 < C ? out_ray[c + 2] : 0.0f,
                                  c + 3 < C ? out_ray[c + 3] : 0.0f);
    }
    for (int k = 0; k < n_stages; ++k) {
      const umhs::SegmentStage& sg = stages.stage[k];  // in the constant bank, no copy
      const T* h = static_cast<const T*>(sg.h);
      const int64_t b0 = sg.starts[r];
      const int32_t n = static_cast<int32_t>(sg.counts[r]);
      const int64_t lane0 = r * sg.L - sg.lo;  // src[b] - lane0: the weight's column
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int32_t t0 = 0; t0 < n; t0 += G) {
        // a lane a row: the row's weight, handed round by shuffle
        const float wv = t0 + gl < n ? w_ray[sg.src[b0 + t0 + gl] - lane0] : 0.0f;
        const int32_t m = min(G, n - t0);
        const T* rows = h + (b0 + t0) * sg.h_stride;
        int32_t u = 0;
        for (; u + 4 <= m; u += 4) {
          float wb[4];
          typename Packed<T>::type x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wb[q] = __shfl_sync(gmask, wv, u + q, G);
            x[q] = load4(rows + (u + q) * sg.h_stride, c, C, sg.vec);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) fma4(acc, wb[q], x[q]);
        }
        for (; u < m; ++u) {
          const float wb = __shfl_sync(gmask, wv, u, G);
          fma4(acc, wb, load4(rows + u * sg.h_stride, c, C, sg.vec));
        }
      }
      if (k == 0 && !chain) {
        tot = acc;
      } else {
        tot.x = __fadd_rn(tot.x, acc.x);
        tot.y = __fadd_rn(tot.y, acc.y);
        tot.z = __fadd_rn(tot.z, acc.z);
        tot.w = __fadd_rn(tot.w, acc.w);
      }
    }
    if (c < C) {
      if (vec_out) {
        *reinterpret_cast<float4*>(out_ray + c) = tot;
      } else {
        out_ray[c] = tot.x;
        if (c + 1 < C) out_ray[c + 1] = tot.y;
        if (c + 2 < C) out_ray[c + 2] = tot.z;
        if (c + 3 < C) out_ray[c + 3] = tot.w;
      }
    }
  }
}

// g: (R, C) contiguous; dh: (Bs, C) contiguous; dw: the stage's (R, L)
// columns of the weights' gradient (row stride dw_stride), zeroed by the
// caller, or null when the weights take no gradient.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
segment_accumulate_bwd_kernel(Segments sg, const T* __restrict__ h, const float* __restrict__ g,
                              T* __restrict__ dh, float* __restrict__ dw) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= sg.Bs) return;  // uniform over the warp
  T* dh_row = dh + b * sg.C;
  if (b >= *sg.total) {
    for (int32_t c = lane; c < sg.C; c += 32) dh_row[c] = store<T>(0.0f);
    return;
  }
  const int64_t f = sg.src[b];
  const float wb = row_weight(sg, f);
  const float* g_row = g + static_cast<int64_t>(static_cast<int32_t>(f) / sg.L) * sg.C;
  const T* h_row = h + b * sg.h_stride;
  float acc = 0.0f;
  for (int32_t c = lane; c < sg.C; c += 32) {
    const float gc = g_row[c];
    dh_row[c] = store<T>(__fmul_rn(wb, gc));
    acc = fmaf(load(h_row + c), gc, acc);
  }
  if (dw == nullptr) return;  // uniform over the warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const int32_t r = static_cast<int32_t>(f) / sg.L, l = static_cast<int32_t>(f) % sg.L;
    dw[static_cast<int64_t>(r) * sg.dw_stride + l] = acc;
  }
}

RayInputs ray_inputs(const float* ts, int64_t ts_stride, const float* te, int64_t te_stride,
                     const float* sigma, int64_t sigma_stride, const uint8_t* mask,
                     int64_t mask_stride, int32_t R, int32_t S, const float* thre_ptr,
                     float thre_val, int32_t use_thre, float eps) {
  return RayInputs{ts, te, sigma, mask, ts_stride, te_stride, sigma_stride, mask_stride,
                   R, S, thre_ptr, thre_val, use_thre, eps};
}

template <int NC>
cudaError_t launch_render_weights_bwd(const RayInputs& in, const float* g, float* dsigma,
                                      float* dts, float* dte, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(in.R) + kWarps - 1) / kWarps);
  render_weights_bwd_kernel<NC><<<blocks, kWarps * 32, 0, stream>>>(in, g, dsigma, dts, dte);
  return cudaGetLastError();
}

}  // namespace

// K6c forward. ts, te, sigma: (R, S) f32 and mask (R, S) bool, each with its
// row stride (elements) and unit column stride; the alpha threshold from
// thre_ptr (a device f32) or thre_val, applied when use_thre; eps the
// early-stop threshold (none when <= 0); w: (R, S) f32 contiguous.
// 0 <= S <= kMaxLanes. Returns a cudaError_t.
extern "C" int umhs_render_weights_fwd(const float* ts, int64_t ts_stride, const float* te,
                                       int64_t te_stride, const float* sigma,
                                       int64_t sigma_stride, const uint8_t* mask,
                                       int64_t mask_stride, int32_t R, int32_t S,
                                       const float* thre_ptr, float thre_val, int32_t use_thre,
                                       float eps, float* w, void* stream) {
  if (R < 0 || S < 0 || S > kMaxLanes) return cudaErrorInvalidValue;
  if (R == 0 || S == 0) return cudaSuccess;
  const RayInputs in = ray_inputs(ts, ts_stride, te, te_stride, sigma, sigma_stride, mask,
                                  mask_stride, R, S, thre_ptr, thre_val, use_thre, eps);
  const unsigned blocks = static_cast<unsigned>((R + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  render_weights_fwd_kernel<<<blocks, kWarps * 32, 0, s>>>(in, w);
  return cudaGetLastError();
}

// K6c backward: the inputs as the forward's, g (R, S) f32 contiguous;
// dsigma, dts, dte (R, S) f32 contiguous, each null when not wanted;
// carries: past kChunks * 32 lanes, (R, ceil(S / (kChunks * 32))) f32
// scratch (umhs_torch/ops/compositing.py's SHORT_SAMPLES is kChunks * 32),
// else null. Returns a cudaError_t.
extern "C" int umhs_render_weights_bwd(const float* ts, int64_t ts_stride, const float* te,
                                       int64_t te_stride, const float* sigma,
                                       int64_t sigma_stride, const uint8_t* mask,
                                       int64_t mask_stride, int32_t R, int32_t S,
                                       const float* thre_ptr, float thre_val, int32_t use_thre,
                                       float eps, const float* g, float* dsigma, float* dts,
                                       float* dte, float* carries, void* stream,
                                       int32_t* route) {
  if (R < 0 || S < 0 || S > kMaxLanes || (S > kChunks * 32 && carries == nullptr))
    return cudaErrorInvalidValue;
  *route = S > kChunks * 32 ? 1 : 0;  // umhs_torch/ops/compositing.py's RENDER_WEIGHTS_BWD_ROUTES
  if (R == 0 || S == 0) return cudaSuccess;
  const RayInputs in = ray_inputs(ts, ts_stride, te, te_stride, sigma, sigma_stride, mask,
                                  mask_stride, R, S, thre_ptr, thre_val, use_thre, eps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S > kChunks * 32) {
    const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(R) + kWarps - 1) / kWarps);
    render_weights_bwd_long_kernel<<<blocks, kWarps * 32, 0, s>>>(in, g, carries, dsigma, dts,
                                                                   dte);
    return cudaGetLastError();
  }
  const auto launch = S <= 32   ? launch_render_weights_bwd<1>
                      : S <= 64  ? launch_render_weights_bwd<2>
                      : S <= 128 ? launch_render_weights_bwd<4>
                                 : launch_render_weights_bwd<8>;
  return launch(in, g, dsigma, dts, dte, s);
}

// The size of umhs::SegmentStage, for the ctypes mirror's check.
extern "C" int umhs_segment_stage_size() { return sizeof(umhs::SegmentStage); }

// K6d forward for one head over n_stages stages (1 <= n_stages <=
// kMaxStages). w: the (R, S) f32 weights, row stride w_stride, unit column
// stride; stages: host array of the stages' descriptors (the stage's lanes
// are w's columns [lo, lo + L)); bf16: the rows' type; G: lanes a ray, a
// power of two <= 32; chain: add onto out (the sums of earlier stages)
// rather than overwrite it; out: (R, C) f32 contiguous. Returns a
// cudaError_t.
extern "C" int umhs_segment_accumulate_fwd(const float* w, int64_t w_stride,
                                           const umhs::SegmentStage* stages, int32_t n_stages,
                                           int32_t bf16, int32_t R, int32_t C, int32_t G,
                                           int32_t chain, float* out, void* stream) {
  if (R < 0 || C < 1 || n_stages < 1 || n_stages > umhs::kMaxStages || G < 1 || G > 32 ||
      (G & (G - 1)) != 0 || static_cast<int64_t>(R) * C >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  umhs::SegmentStages st{};
  for (int k = 0; k < n_stages; ++k) {
    const umhs::SegmentStage& sg = stages[k];
    const int align = bf16 ? 8 : 16;
    if (sg.L < 1 || sg.lo < 0 || sg.h_stride < C ||
        (sg.vec && ((C & 3) != 0 || (sg.h_stride & 3) != 0 ||
                    reinterpret_cast<uintptr_t>(sg.h) % align != 0)))
      return cudaErrorInvalidValue;
    st.stage[k] = sg;
  }
  if (R == 0) return cudaSuccess;
  const int64_t threads = static_cast<int64_t>(R) * G;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    segment_accumulate_fwd_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        w, w_stride, st, n_stages, R, C, G, chain, out);
  else
    segment_accumulate_fwd_kernel<float><<<blocks, kThreads, 0, s>>>(w, w_stride, st, n_stages,
                                                                     R, C, G, chain, out);
  return cudaGetLastError();
}

// K6d backward for one stage: w: the stage's (R, L) f32 weights, row
// stride w_stride; src (Bs) int64 and total (1) int32 (K6a's); h: (Bs, C)
// f32 or bf16 (bf16 = 1) of row stride h_stride; g: (R, C) f32 contiguous;
// dh: (Bs, C) contiguous in h's type; dw: the stage's (R, L) f32 columns of
// the weights' gradient, row stride dw_stride, zeroed, or null. Returns a
// cudaError_t.
extern "C" int umhs_segment_accumulate_bwd(const float* w, int64_t w_stride, int32_t L,
                                           const int64_t* src, const int32_t* total,
                                           const void* h, int64_t h_stride, int32_t bf16,
                                           const float* g, int32_t R, int32_t C, int32_t Bs,
                                           void* dh, float* dw, int64_t dw_stride,
                                           void* stream) {
  if (R < 0 || C < 1 || L < 1 || Bs < 1 || (dw != nullptr && dw_stride < L))
    return cudaErrorInvalidValue;
  const Segments sg{w, w_stride, L, src, total, h_stride, dw_stride, R, C, Bs};
  const unsigned blocks = static_cast<unsigned>((static_cast<int64_t>(Bs) + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    segment_accumulate_bwd_kernel<<<blocks, kWarps * 32, 0, s>>>(
        sg, static_cast<const __nv_bfloat16*>(h), g, static_cast<__nv_bfloat16*>(dh), dw);
  else
    segment_accumulate_bwd_kernel<<<blocks, kWarps * 32, 0, s>>>(
        sg, static_cast<const float*>(h), g, static_cast<float*>(dh), dw);
  return cudaGetLastError();
}
