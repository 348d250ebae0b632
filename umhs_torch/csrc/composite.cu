// K6c and K6d: volume-rendering weights and the per-ray sums over the compact
// buffer, forward and backward.
//
// K6c replaces umhs_tpu/ops/compositing.py::render_weights (lines 34-73), and
// K6d replaces segment_accumulate (lines 84-115) with the gather of the
// weights through `src` (umhs_tpu/models/model.py:520-549) folded in. Both
// are XLA on the TPU; in the original system nerfacc's
// render_weight_from_density and accumulate_along_rays did this work.
//
// K6c, on (R, S) lanes, S <= 256, one warp a ray, the lanes in chunks of 32:
//   delta = max(t_end - t_start, 0); x = mask ? sigma * delta : 0;
//   a = 1 - exp(-x); keep = mask && a >= alpha_thre (every lane when the
//   filter is off); x' = keep ? x : 0; c = the exclusive scan of x';
//   T = exp(-c); alive = T >= eps (every lane when eps <= 0);
//   w = (keep && alive ? a : 0) * T.
// The scan runs in the warp with shuffles, chunk after chunk with a carry.
// Its backward recomputes the forward, then takes the exclusive suffix sum
// of g * w the same way from the last chunk down:
//   dx = keep ? (alive ? g * T * exp(-x) : 0) - sum_{j > i} g_j w_j : 0,
//   dsigma = mask ? dx * delta : 0, ddelta = mask ? dx * sigma : 0, passed
//   where t_end - t_start >= 0 (torch's clamp_min), to t_end and -t_start.
//
// K6d, for one stage: out[r, c] = sum over the ray's run of rows
// b in [starts[r], starts[r] + counts[r]) of w[src[b]] * h[b, c], summed in
// ascending b in f32 (the runs are read directly, not as a prefix sum's
// difference); a thread per (r, c). Its backward, a warp a row: for
// b < total, dh[b, c] = w[src[b]] * g[ray(b), c] and
// dw[src[b]] = sum_c h[b, c] * g[ray(b), c] (a store to a lane no other row
// writes; the caller zeroes dw), with ray(b) = src[b] / L; rows past total
// get dh = 0 and write nothing else. h is f32 or bf16; sums are f32.
//
// No atomics anywhere: each output is written by one thread and every sum
// is taken in a fixed order, so every run gives the same bits.
//
// What bounds them on an H100: bytes. K6c reads four (R, S) inputs and
// writes one (its backward reads five and writes up to three); K6d reads
// the heads once (Bs x C) and writes (R, C). The designs are the simple ones:
// coalesced chunk loads in K6c, neighbouring threads on neighbouring
// channels of one row in K6d.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;      // rays (K6c) or rows (K6d's backward) per block
constexpr int kChunks = 8;     // K6c: S <= kChunks * 32
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

// One lane's forward values.
struct Lane {
  float delta, sigma, x, a, T;
  bool on, keep, alive;
};

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

// The forward of every lane of ray r, chunk k at lane `lane`; L[k] filled.
__device__ __forceinline__ void forward_lanes(const RayInputs& in, int64_t r, int lane,
                                              Lane* L) {
  const float thre = in.use_thre ? (in.thre_ptr ? *in.thre_ptr : in.thre_val) : 0.0f;
  float carry = 0.0f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (k * 32 >= in.S) break;  // uniform over the warp
    const int s = k * 32 + lane;
    Lane& v = L[k];
    v.on = s < in.S && in.mask[r * in.mask_stride + s] != 0;
    v.delta = 0.0f;
    v.sigma = 0.0f;
    v.x = 0.0f;
    if (s < in.S) {
      v.delta = fmaxf(in.te[r * in.te_stride + s] - in.ts[r * in.ts_stride + s], 0.0f);
      v.sigma = in.sigma[r * in.sigma_stride + s];
      if (v.on) v.x = __fmul_rn(v.sigma, v.delta);
    }
    v.a = 1.0f - expf(-v.x);
    v.keep = in.use_thre ? (v.on && v.a >= thre) : true;
    float chunk_total;
    const float c = carry + warp_exclusive_scan(v.keep ? v.x : 0.0f, lane, &chunk_total);
    carry += chunk_total;
    v.T = expf(-c);
    v.alive = in.eps <= 0.0f || v.T >= in.eps;
  }
}

__device__ __forceinline__ float lane_weight(const Lane& v) {
  return __fmul_rn(v.keep && v.alive ? v.a : 0.0f, v.T);
}

__global__ void __launch_bounds__(kWarps * 32)
render_weights_fwd_kernel(RayInputs in, float* __restrict__ w) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= in.R) return;  // uniform over the warp
  Lane L[kChunks];
  forward_lanes(in, r, lane, L);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int s = k * 32 + lane;
    if (k * 32 >= in.S) break;
    if (s < in.S) w[r * in.S + s] = lane_weight(L[k]);
  }
}

// g: (R, S) contiguous; dsigma, dts, dte: (R, S) contiguous, each null when
// not wanted.
__global__ void __launch_bounds__(kWarps * 32)
render_weights_bwd_kernel(RayInputs in, const float* __restrict__ g, float* __restrict__ dsigma,
                          float* __restrict__ dts, float* __restrict__ dte) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= in.R) return;  // uniform over the warp
  Lane L[kChunks];
  forward_lanes(in, r, lane, L);
  float after = 0.0f;  // sum of g * w over the chunks past this one
#pragma unroll
  for (int k = kChunks - 1; k >= 0; --k) {
    if (k * 32 >= in.S) continue;  // uniform over the warp
    const int s = k * 32 + lane;
    const Lane& v = L[k];
    const float gk = s < in.S ? g[r * in.S + s] : 0.0f;
    float chunk_total;
    const float later = after + warp_exclusive_suffix(__fmul_rn(gk, lane_weight(v)), lane,
                                                      &chunk_total);
    after += chunk_total;
    if (s >= in.S) continue;
    float dx = 0.0f;
    if (v.keep) {
      const float direct = v.alive ? __fmul_rn(__fmul_rn(gk, v.T), expf(-v.x)) : 0.0f;
      dx = direct - later;
    }
    const int64_t o = r * in.S + s;
    const float dx_on = v.on ? dx : 0.0f;
    if (dsigma) dsigma[o] = __fmul_rn(dx_on, v.delta);
    if (dts || dte) {
      const float diff = in.te[r * in.te_stride + s] - in.ts[r * in.ts_stride + s];
      const float dd = diff >= 0.0f ? __fmul_rn(dx_on, v.sigma) : 0.0f;
      if (dte) dte[o] = dd;
      if (dts) dts[o] = -dd;
    }
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

struct Segments {
  const float* w;  // the stage's (R, L) weights, row stride w_stride
  int64_t w_stride;
  int32_t L;
  const int64_t* src;     // (Bs,)
  const int64_t* starts;  // (R,)
  const int64_t* counts;  // (R,)
  const int32_t* total;   // (1,)
  int64_t h_stride;       // the heads' row stride (elements)
  int32_t R, C, Bs;
};

// The weight of flat lane f (< R * L < 2^31: 32-bit division).
__device__ __forceinline__ float row_weight(const Segments& sg, int64_t f) {
  const int32_t r = static_cast<int32_t>(f) / sg.L, l = static_cast<int32_t>(f) % sg.L;
  return sg.w[static_cast<int64_t>(r) * sg.w_stride + l];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_accumulate_fwd_kernel(Segments sg, const T* __restrict__ h, float* __restrict__ out) {
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;  // R * C < 2^31
  if (i >= sg.R * sg.C) return;
  const int32_t r = i / sg.C, c = i % sg.C;
  const int64_t b0 = sg.starts[r], b1 = b0 + sg.counts[r];
  float acc = 0.0f;
  for (int64_t b = b0; b < b1; ++b)
    acc = fmaf(row_weight(sg, sg.src[b]), load(h + b * sg.h_stride + c), acc);
  out[i] = acc;
}

// g: (R, C) contiguous; dh: (Bs, C) contiguous; dw: (R, L) contiguous, zeroed
// by the caller, or null when the weights take no gradient.
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
  if (lane == 0) dw[f] = acc;
}

RayInputs ray_inputs(const float* ts, int64_t ts_stride, const float* te, int64_t te_stride,
                     const float* sigma, int64_t sigma_stride, const uint8_t* mask,
                     int64_t mask_stride, int32_t R, int32_t S, const float* thre_ptr,
                     float thre_val, int32_t use_thre, float eps) {
  return RayInputs{ts, te, sigma, mask, ts_stride, te_stride, sigma_stride, mask_stride,
                   R, S, thre_ptr, thre_val, use_thre, eps};
}

}  // namespace

// K6c forward. ts, te, sigma: (R, S) f32 and mask (R, S) bool, each with its
// row stride (elements) and unit column stride; the alpha threshold from
// thre_ptr (a device f32) or thre_val, applied when use_thre; eps the
// early-stop threshold (none when <= 0); w: (R, S) f32 contiguous.
// 1 <= S <= 256. Returns a cudaError_t.
extern "C" int umhs_render_weights_fwd(const float* ts, int64_t ts_stride, const float* te,
                                       int64_t te_stride, const float* sigma,
                                       int64_t sigma_stride, const uint8_t* mask,
                                       int64_t mask_stride, int32_t R, int32_t S,
                                       const float* thre_ptr, float thre_val, int32_t use_thre,
                                       float eps, float* w, void* stream) {
  if (R < 0 || S < 1 || S > kChunks * 32) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const RayInputs in = ray_inputs(ts, ts_stride, te, te_stride, sigma, sigma_stride, mask,
                                  mask_stride, R, S, thre_ptr, thre_val, use_thre, eps);
  render_weights_fwd_kernel<<<static_cast<unsigned>((R + kWarps - 1) / kWarps), kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(in, w);
  return cudaGetLastError();
}

// K6c backward: the inputs as the forward's, g (R, S) f32 contiguous;
// dsigma, dts, dte (R, S) f32 contiguous, each null when not wanted.
// Returns a cudaError_t.
extern "C" int umhs_render_weights_bwd(const float* ts, int64_t ts_stride, const float* te,
                                       int64_t te_stride, const float* sigma,
                                       int64_t sigma_stride, const uint8_t* mask,
                                       int64_t mask_stride, int32_t R, int32_t S,
                                       const float* thre_ptr, float thre_val, int32_t use_thre,
                                       float eps, const float* g, float* dsigma, float* dts,
                                       float* dte, void* stream) {
  if (R < 0 || S < 1 || S > kChunks * 32) return cudaErrorInvalidValue;
  if (R == 0) return cudaSuccess;
  const RayInputs in = ray_inputs(ts, ts_stride, te, te_stride, sigma, sigma_stride, mask,
                                  mask_stride, R, S, thre_ptr, thre_val, use_thre, eps);
  render_weights_bwd_kernel<<<static_cast<unsigned>((R + kWarps - 1) / kWarps), kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(in, g, dsigma, dts, dte);
  return cudaGetLastError();
}

// K6d forward. w: the stage's (R, L) f32 weights, row stride w_stride; src
// (Bs) int64, starts and counts (R) int64 (K6a's); h: (Bs, C) f32 or bf16
// (bf16 = 1) of row stride h_stride; out: (R, C) f32 contiguous. Returns a
// cudaError_t.
extern "C" int umhs_segment_accumulate_fwd(const float* w, int64_t w_stride, int32_t L,
                                           const int64_t* src, const int64_t* starts,
                                           const int64_t* counts, const void* h,
                                           int64_t h_stride, int32_t bf16, int32_t R, int32_t C,
                                           int32_t Bs, float* out, void* stream) {
  const int64_t n = static_cast<int64_t>(R) * C;
  if (R < 0 || C < 1 || L < 1 || Bs < 1 || n >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Segments sg{w, w_stride, L, src, starts, counts, nullptr, h_stride, R, C, Bs};
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    segment_accumulate_fwd_kernel<<<blocks, kThreads, 0, s>>>(
        sg, static_cast<const __nv_bfloat16*>(h), out);
  else
    segment_accumulate_fwd_kernel<<<blocks, kThreads, 0, s>>>(sg, static_cast<const float*>(h),
                                                              out);
  return cudaGetLastError();
}

// K6d backward: w, src, h as the forward's; total (1) int32 (K6a's); g: (R,
// C) f32 contiguous; dh: (Bs, C) contiguous in h's type; dw: (R, L) f32
// contiguous and zeroed, or null. Returns a cudaError_t.
extern "C" int umhs_segment_accumulate_bwd(const float* w, int64_t w_stride, int32_t L,
                                           const int64_t* src, const int32_t* total,
                                           const void* h, int64_t h_stride, int32_t bf16,
                                           const float* g, int32_t R, int32_t C, int32_t Bs,
                                           void* dh, float* dw, void* stream) {
  if (R < 0 || C < 1 || L < 1 || Bs < 1) return cudaErrorInvalidValue;
  const Segments sg{w, w_stride, L, src, nullptr, nullptr, total, h_stride, R, C, Bs};
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
