// K2: fused multi-layer MLP backward.
//
// Replaces umhs_tpu/ops/pallas/mlp_fused.py::_bwd_kernel (launched by
// _mlp_fused_vjp_bwd, pallas_call at line 157). For each tile of rows the
// kernel recomputes the forward chain (no hidden activation is kept between
// forward and backward, as in the Pallas kernel), keeps every layer's input
// in shared memory, then walks the layers backwards: ReLU mask, db = sum dh,
// dW = a^T . dh, dh <- dh . W^T, and writes dx for its rows.
//
// The reduction across tiles. The TPU grid runs in order, so the Pallas
// kernel sums dW/db with += into one output block. CUDA blocks run in no
// order: each block here walks its own tiles (tile = blockIdx.x, +gridDim.x,
// ...) and sums dW/db into its own row of a scratch buffer of partials
// (blocks x params, allocated by the wrapper); a second kernel sums the rows
// in block order. A run gives the same bits every time (no float atomics).
//
// Numerics follow the Pallas rounding points. f32 mode: plain f32. bf16
// mode: x and W_i rounded to bf16, products summed in f32, b_i added in f32,
// ReLU, activations rounded to bf16 (the forward of K1); backward: the ReLU
// mask is post-activation > 0, db sums the masked dh in f32, then dh is
// rounded to bf16 for both dW = a^T . dh and dh . W^T, with f32 sums; dx is
// f32. Rows past n in the last tile read x = 0 and g = 0, so their dh is 0
// and they add nothing to dW or db.
//
// What bounds it on an H100: at the field's widths the backward does about
// three times the forward's multiply-adds per row (recompute, dW, dh) over
// 100-700 bytes of x, g and dx per row, so an ideal kernel is bound by bytes.
// This first version is bound by shared-memory traffic: each thread keeps a
// 4x4 block of outputs in registers; activations and dh are stored
// transposed (feature-major, rows padded by 4 floats) so the row-blocked
// products read float4s along rows, and the dW product has each thread own
// rows i, i + D/4, i + 2D/4, i + 3D/4 so a warp's float4 reads fall in
// distinct banks. Tensor cores (wgmma) are the next step for speed.
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;
constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

struct Dims {
  int d[kMaxLayers + 1];
  int num_layers;
  int tile_rows;     // rows per tile, a multiple of 4
  int stride;        // floats between transposed rows: tile_rows + 4
  int max_width4;    // widest layer (input and output included), rounded up to 4
  int w_floats;      // padded weights + biases in shared memory
  int act_floats;    // transposed inputs of every layer in shared memory
  int param_floats;  // unpadded weights + biases (global layout)
  int soff[kMaxLayers];  // layer l's W in shared memory: (round4(din) x round4(dout)), then b
  int goff[kMaxLayers];  // layer l's W in the global layout: (din x dout), then b
  int aoff[kMaxLayers];  // layer l's input in shared memory: (round4(din) x stride)
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Forward layer on a tile: out(r, c) = relu(sum_k a(r, k) W(k, c) + b(c)),
// rounded to bf16 in bf16 mode. a and out are transposed (a[k * ts + r]).
template <bool kBf16>
__device__ void layer_forward(const float* a, const float* W, int din, int dout4,
                              float* out, int tr, int ts) {
  const float* b = W + round4(din) * dout4;
  const int row_groups = tr / 4;
  const int items = row_groups * (dout4 / 4);
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int r = (item % row_groups) * 4;
    const int c = (item / row_groups) * 4;
    float acc[4][4] = {};
    for (int k = 0; k < din; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(a + k * ts + r);
      const float4 wv = *reinterpret_cast<const float4*>(W + k * dout4 + c);
      const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
      const float wp[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(hq[q], wp[p], acc[q][p]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float h = fmaxf(acc[q][p] + b[c + p], 0.f);
        v[q] = kBf16 ? to_bf16(h) : h;
      }
      *reinterpret_cast<float4*>(out + (c + p) * ts + r) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// dW(i, j) += sum_r a(r, i) dh(r, j) over the tile, into the block's partial
// pW (din x dout, row-major). a and dh are transposed.
__device__ void layer_dw(const float* a, const float* dh, int din, int dout, int tr, int ts,
                         float* pW) {
  const int di = round4(din) / 4, dj = round4(dout) / 4;
  const int items = di * dj;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int ib = item % di, jb = item / di;
    float acc[4][4] = {};
    for (int r = 0; r < tr; r += 4) {
      float4 av[4], dv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        av[q] = *reinterpret_cast<const float4*>(a + (ib + q * di) * ts + r);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        dv[p] = *reinterpret_cast<const float4*>(dh + (jb + p * dj) * ts + r);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          acc[q][p] = fmaf(av[q].x, dv[p].x, acc[q][p]);
          acc[q][p] = fmaf(av[q].y, dv[p].y, acc[q][p]);
          acc[q][p] = fmaf(av[q].z, dv[p].z, acc[q][p]);
          acc[q][p] = fmaf(av[q].w, dv[p].w, acc[q][p]);
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = ib + q * di;
      if (i >= din) continue;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int j = jb + p * dj;
        if (j < dout) pW[i * dout + j] += acc[q][p];
      }
    }
  }
}

// dn(r, i) = sum_j dh(r, j) W(i, j): the gradient of the layer's input.
// dh and dn are transposed; W is (round4(din) x dout4), zero-padded.
__device__ void layer_dinput(const float* dh, const float* W, int dout, int din4, int dout4,
                             float* dn, int tr, int ts) {
  const int row_groups = tr / 4;
  const int items = row_groups * (din4 / 4);
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int r = (item % row_groups) * 4;
    const int c = (item / row_groups) * 4;
    float acc[4][4] = {};
    for (int j = 0; j < dout; ++j) {
      const float4 hv = *reinterpret_cast<const float4*>(dh + j * ts + r);
      const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
      float wp[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) wp[p] = W[(c + p) * dout4 + j];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(hq[q], wp[p], acc[q][p]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<float4*>(dn + (c + p) * ts + r) =
          make_float4(acc[0][p], acc[1][p], acc[2][p], acc[3][p]);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mlp_fused_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const float* __restrict__ params, float* __restrict__ dx,
                     float* __restrict__ partials, int n, Dims dims) {
  extern __shared__ __align__(16) float smem[];
  const int tr = dims.tile_rows, ts = dims.stride, L = dims.num_layers;
  float* wb = smem;
  float* acts = smem + dims.w_floats;
  float* dh_a = acts + dims.act_floats;
  float* dh_b = dh_a + dims.max_width4 * ts;
  float* part = partials + static_cast<size_t>(blockIdx.x) * dims.param_floats;

  // Weights (rounded in bf16 mode) and f32 biases, zero-padded; this
  // block's partial sums start at zero.
  for (int i = threadIdx.x; i < dims.w_floats; i += kThreads) wb[i] = 0.f;
  for (int i = threadIdx.x; i < dims.param_floats; i += kThreads) part[i] = 0.f;
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    const int din = dims.d[l], dout = dims.d[l + 1], dout4 = round4(dout);
    const float* src = params + dims.goff[l];
    float* W = wb + dims.soff[l];
    for (int i = threadIdx.x; i < din * dout; i += kThreads) {
      const float v = src[i];
      W[(i / dout) * dout4 + (i % dout)] = kBf16 ? to_bf16(v) : v;
    }
    for (int i = threadIdx.x; i < dout; i += kThreads)
      W[round4(din) * dout4 + i] = src[din * dout + i];
  }
  __syncthreads();

  const int din0 = dims.d[0];
  const int dlast = dims.d[L];
  const int num_tiles = (n + tr - 1) / tr;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = static_cast<int64_t>(tile) * tr;
    const int rows = n - row0 < tr ? static_cast<int>(n - row0) : tr;
    const float* xt = x + row0 * din0;
    for (int i = threadIdx.x; i < tr * din0; i += kThreads) {
      const int r = i / din0, k = i % din0;
      const float v = r < rows ? xt[i] : 0.f;
      acts[k * ts + r] = kBf16 ? to_bf16(v) : v;
    }
    const float* gt = g + row0 * dlast;
    for (int i = threadIdx.x; i < tr * dlast; i += kThreads) {
      const int r = i / dlast, k = i % dlast;
      dh_a[k * ts + r] = r < rows ? gt[i] : 0.f;
    }
    __syncthreads();

    // forward recompute: the input of every layer above the first
    for (int l = 0; l + 1 < L; ++l) {
      layer_forward<kBf16>(acts + dims.aoff[l], wb + dims.soff[l], dims.d[l],
                           round4(dims.d[l + 1]), acts + dims.aoff[l + 1], tr, ts);
      __syncthreads();
    }

    float* dh = dh_a;
    float* dn = dh_b;
    for (int l = L - 1; l >= 0; --l) {
      const int din = dims.d[l], dout = dims.d[l + 1];
      float* pW = part + dims.goff[l];
      float* pb = pW + din * dout;
      // ReLU mask of the layer's output (all but the last layer), db in f32,
      // then dh rounded for the two products
      const float* post = l + 1 < L ? acts + dims.aoff[l + 1] : nullptr;
      for (int j = threadIdx.x; j < dout; j += kThreads) {
        float* col = dh + j * ts;
        float s = 0.f;
        for (int r = 0; r < tr; ++r) {
          float v = col[r];
          if (post != nullptr) v *= post[j * ts + r] > 0.f ? 1.f : 0.f;
          s += v;
          col[r] = kBf16 ? to_bf16(v) : v;
        }
        pb[j] += s;
      }
      __syncthreads();
      layer_dw(acts + dims.aoff[l], dh, din, dout, tr, ts, pW);
      if (l > 0 || dx != nullptr)
        layer_dinput(dh, wb + dims.soff[l], dout, round4(din), round4(dout), dn, tr, ts);
      __syncthreads();
      float* t = dh;
      dh = dn;
      dn = t;
    }

    if (dx != nullptr) {
      // the dx tile is row-major and contiguous in dx
      float* dxt = dx + row0 * din0;
      for (int i = threadIdx.x; i < rows * din0; i += kThreads)
        dxt[i] = dh[(i % din0) * ts + i / din0];
    }
    __syncthreads();
  }
}

// out[p] = sum over blocks b, in order, of partials[b * count + p].
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                       int blocks, int count) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= count) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[static_cast<size_t>(b) * count + p];
  out[p] = s;
}

template <bool kBf16>
cudaError_t launch(const float* x, const float* g, const float* params, float* dx,
                   float* partials, float* dparams, int n, const Dims& dims, size_t smem,
                   int max_blocks, cudaStream_t stream) {
  auto kernel = mlp_fused_bwd_kernel<kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + dims.tile_rows - 1) / dims.tile_rows;
  const int grid = std::max(1, std::min({tiles, std::max(per_sm, 1) * umhs::num_sms(),
                                         max_blocks}));
  kernel<<<grid, kThreads, smem, stream>>>(x, g, params, dx, partials, n, dims);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = dims.param_floats;
  reduce_partials_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partials, dparams, grid, count);
  return cudaGetLastError();
}

}  // namespace

// x: (n, dims[0]) f32; g: (n, dims[num_layers]) f32, the gradient of the
// chain's output; params: [W0, b0, W1, b1, ...] f32 as for K1. Writes dx
// (n, dims[0]) unless dx is null, and dparams in the params layout.
// partials: scratch of max_blocks x len(params) floats (max_blocks >= 1).
// Returns a cudaError_t.
extern "C" int umhs_mlp_fused_bwd(const float* x, const float* g, const float* params,
                                  float* dx, float* partials, float* dparams,
                                  const int* dims_host, int num_layers, int n, int bf16,
                                  int max_blocks, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || n < 0 || max_blocks < 1)
    return cudaErrorInvalidValue;
  Dims dims{};
  dims.num_layers = num_layers;
  int max_width4 = 0, w_floats = 0, param_floats = 0, act_rows = 0;
  for (int l = 0; l <= num_layers; ++l) {
    const int w = dims_host[l];
    if (w < 1 || w > kMaxWidth) return cudaErrorInvalidValue;
    dims.d[l] = w;
    max_width4 = std::max(max_width4, round4(w));
  }
  for (int l = 0; l < num_layers; ++l) {
    const int din = dims.d[l], dout = dims.d[l + 1];
    dims.soff[l] = w_floats;
    dims.goff[l] = param_floats;
    dims.aoff[l] = act_rows;  // in rows of `stride` floats until the tile is chosen
    w_floats += round4(din) * round4(dout) + round4(dout);
    param_floats += din * dout + dout;
    act_rows += round4(din);
  }
  dims.max_width4 = max_width4;
  dims.w_floats = w_floats;
  dims.param_floats = param_floats;
  // Largest tile that leaves room for two blocks per SM (else for one).
  auto smem_for = [&](int tr) {
    return sizeof(float) * (static_cast<size_t>(w_floats) +
                            static_cast<size_t>(act_rows + 2 * max_width4) * (tr + 4));
  };
  int tr = 0;
  for (const size_t limit : {static_cast<size_t>(kSmemLimit / 2), static_cast<size_t>(kSmemLimit)}) {
    for (int t = 128; t >= 4 && !tr; t /= 2)
      if (smem_for(t) <= limit) tr = t;
    if (tr) break;
  }
  if (!tr) return cudaErrorInvalidValue;
  dims.tile_rows = tr;
  dims.stride = tr + 4;
  for (int l = 0; l < num_layers; ++l) dims.aoff[l] *= dims.stride;
  dims.act_floats = act_rows * dims.stride;
  const size_t smem = smem_for(tr);
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(x, g, params, dx, partials, dparams, n, dims, smem, max_blocks, s)
              : launch<false>(x, g, params, dx, partials, dparams, n, dims, smem, max_blocks, s);
}
