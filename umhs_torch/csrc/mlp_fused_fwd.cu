// K1: fused multi-layer MLP forward.
//
// Replaces umhs_tpu/ops/pallas/mlp_fused.py::_fwd_kernel (launched by
// _mlp_fused_fwd_only, pallas_call at line 126). One launch runs the whole
// layer chain h <- h.W_i + b_i (ReLU between layers, linear last layer) for
// tiles of rows: x is read from device memory once and y written once, and
// every hidden activation stays in shared memory.
//
// What bounds it on an H100: at the field's widths (16-128) the chain does
// 3-20k multiply-adds per row against 100-700 bytes of x and y per row, so
// an ideal kernel is bound by bytes. This first version is bound by its
// shared-memory traffic instead: each thread keeps a 4x4 block of outputs
// in registers and streams the tile's activations (stored transposed, so a
// warp's float4 loads are contiguous) and the weights (a broadcast float4
// per k) from shared memory. The transposed rows are padded by 4 floats so
// the row-major staging of x and of y hits 8 banks instead of 1; x is read
// and y written with coalesced accesses. Tensor cores (wgmma) are the next
// step for speed.
//
// Numerics. f32 mode: plain f32 fused multiply-adds. bf16 mode follows the
// Pallas kernel's rounding points: x and W_i are rounded to bf16, products
// are accumulated in f32, b_i is added in f32, ReLU, then the activation is
// rounded to bf16 before the next layer; the output is f32. (The JAX plain
// path, and so the port's plain version, also rounds b_i to bf16; the bf16
// tolerance of 2e-2 used by both repos' tests covers that gap.)
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;
constexpr int kThreads = 256;
constexpr int kRB = 4;  // rows per thread
constexpr int kCB = 4;  // columns per thread
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

struct Dims {
  int d[kMaxLayers + 1];
  int num_layers;
  int tile_rows;    // rows per tile, a multiple of kRB
  int stride;       // floats between transposed activation rows: tile_rows + 4
  int max_width4;   // widest layer, rounded up to kCB
  int param_floats; // padded weights + biases in shared memory
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mlp_fused_fwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ params,
                     float* __restrict__ y, int n, Dims dims) {
  extern __shared__ __align__(16) float smem[];
  const int tr = dims.tile_rows, ts = dims.stride;
  float* wb = smem;  // per layer: W (din x dout4, zero-padded), b (dout4)
  float* act0 = smem + dims.param_floats;  // transposed: act[k * ts + r]
  float* act1 = act0 + dims.max_width4 * ts;

  // Stage weights and biases once per block. Global layout is unpadded
  // [W0 (din x dout, row-major), b0, W1, b1, ...].
  for (int i = threadIdx.x; i < dims.param_floats; i += kThreads) wb[i] = 0.f;
  __syncthreads();
  {
    int goff = 0, soff = 0;
    for (int l = 0; l < dims.num_layers; ++l) {
      const int din = dims.d[l], dout = dims.d[l + 1], dout4 = round4(dout);
      for (int i = threadIdx.x; i < din * dout; i += kThreads) {
        const float v = params[goff + i];
        wb[soff + (i / dout) * dout4 + (i % dout)] = kBf16 ? to_bf16(v) : v;
      }
      for (int i = threadIdx.x; i < dout; i += kThreads)
        wb[soff + din * dout4 + i] = params[goff + din * dout + i];
      goff += din * dout + dout;
      soff += din * dout4 + dout4;
    }
  }
  __syncthreads();

  const int din0 = dims.d[0];
  const int dlast = dims.d[dims.num_layers];
  const int num_tiles = (n + tr - 1) / tr;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = static_cast<int64_t>(tile) * tr;
    const int rows = n - row0 < tr ? static_cast<int>(n - row0) : tr;
    const float* xt = x + row0 * din0;
    for (int i = threadIdx.x; i < tr * din0; i += kThreads) {
      const int r = i / din0, k = i % din0;
      const float v = r < rows ? xt[i] : 0.f;
      act0[k * ts + r] = kBf16 ? to_bf16(v) : v;
    }
    __syncthreads();

    const float* h = act0;
    float* hn = act1;
    int soff = 0;
    for (int l = 0; l < dims.num_layers; ++l) {
      const int din = dims.d[l], dout = dims.d[l + 1], dout4 = round4(dout);
      const float* W = wb + soff;
      const float* b = W + din * dout4;
      const bool last = l + 1 == dims.num_layers;
      const int row_groups = tr / kRB;
      const int items = row_groups * (dout4 / kCB);
      for (int item = threadIdx.x; item < items; item += kThreads) {
        const int r = (item % row_groups) * kRB;
        const int c = (item / row_groups) * kCB;
        float acc[kRB][kCB];
#pragma unroll
        for (int q = 0; q < kRB; ++q)
#pragma unroll
          for (int p = 0; p < kCB; ++p) acc[q][p] = 0.f;
        for (int k = 0; k < din; ++k) {
          const float4 hv = *reinterpret_cast<const float4*>(h + k * ts + r);
          const float4 wv = *reinterpret_cast<const float4*>(W + k * dout4 + c);
          const float hq[kRB] = {hv.x, hv.y, hv.z, hv.w};
          const float wp[kCB] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int q = 0; q < kRB; ++q)
#pragma unroll
            for (int p = 0; p < kCB; ++p) acc[q][p] = fmaf(hq[q], wp[p], acc[q][p]);
        }
        const float4 bv = *reinterpret_cast<const float4*>(b + c);
        const float bp[kCB] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int p = 0; p < kCB; ++p) {
          float v[kRB];
#pragma unroll
          for (int q = 0; q < kRB; ++q) {
            const float a = acc[q][p] + bp[p];
            v[q] = last ? a : (kBf16 ? to_bf16(fmaxf(a, 0.f)) : fmaxf(a, 0.f));
          }
          *reinterpret_cast<float4*>(hn + (c + p) * ts + r) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      __syncthreads();
      if (last) {
        // the output tile is row-major and contiguous in y
        float* yt = y + row0 * dlast;
        for (int i = threadIdx.x; i < rows * dlast; i += kThreads)
          yt[i] = hn[(i % dlast) * ts + i / dlast];
        __syncthreads();
      }
      const float* t = h;
      h = hn;
      hn = const_cast<float*>(t);
      soff += din * dout4 + dout4;
    }
  }
}

template <bool kBf16>
cudaError_t launch(const float* x, const float* params, float* y, int n,
                   const Dims& dims, size_t smem, cudaStream_t stream) {
  auto kernel = mlp_fused_fwd_kernel<kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + dims.tile_rows - 1) / dims.tile_rows;
  const int grid = std::min(tiles, std::max(per_sm, 1) * umhs::num_sms());
  kernel<<<grid, kThreads, smem, stream>>>(x, params, y, n, dims);
  return cudaGetLastError();
}

}  // namespace

// x: (n, dims[0]) f32; params: [W0, b0, W1, b1, ...] f32 with W_i row-major
// (dims[i], dims[i+1]); y: (n, dims[num_layers]) f32. Returns a cudaError_t.
extern "C" int umhs_mlp_fused_fwd(const float* x, const float* params, float* y,
                                  const int* dims_host, int num_layers, int n,
                                  int bf16, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || n < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Dims dims{};
  dims.num_layers = num_layers;
  int max_width4 = 0, param_floats = 0;
  for (int l = 0; l <= num_layers; ++l) {
    const int w = dims_host[l];
    if (w < 1 || w > kMaxWidth) return cudaErrorInvalidValue;
    dims.d[l] = w;
    max_width4 = std::max(max_width4, round4(w));
    if (l > 0) param_floats += dims_host[l - 1] * round4(w) + round4(w);
  }
  dims.max_width4 = max_width4;
  dims.param_floats = param_floats;
  // Largest tile that leaves room for two blocks per SM (else for one):
  // 128 rows make a warp's 32 row groups share one weight column block
  // (broadcast loads); wider chains take fewer rows.
  auto smem_for = [&](int tr) {
    return sizeof(float) * (static_cast<size_t>(param_floats) +
                            2 * static_cast<size_t>(max_width4) * (tr + 4));
  };
  int tr = 0;
  for (const size_t limit : {static_cast<size_t>(kSmemLimit / 2), static_cast<size_t>(kSmemLimit)}) {
    for (int t = 128; t >= kRB && !tr; t /= 2)
      if (smem_for(t) <= limit) tr = t;
    if (tr) break;
  }
  if (!tr) return cudaErrorInvalidValue;
  const size_t smem = smem_for(tr);
  dims.tile_rows = tr;
  dims.stride = tr + 4;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(x, params, y, n, dims, smem, s)
              : launch<false>(x, params, y, n, dims, smem, s);
}
