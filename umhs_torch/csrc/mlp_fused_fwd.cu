// K1: fused multi-layer MLP forward.
//
// Replaces umhs_tpu/ops/pallas/mlp_fused.py::_fwd_kernel (launched by
// _mlp_fused_fwd_only, pallas_call at line 126). One launch runs the whole
// layer chain h <- h.W_i + b_i (ReLU between layers, linear last layer) for
// tiles of rows: x is read from device memory once and y written once, and
// no hidden activation goes to device memory.
//
// What bounds it on an H100: at the field's widths (16-128) the chain does
// 3-20k multiply-adds per row against 100-700 bytes of x and y per row. On
// the tensor cores that work is small (the four flagship chains at 2^20
// rows: 39.7 GFLOP padded, ~0.04 ms at the bf16 peak) and an ideal kernel is
// bound by bytes (0.339 ms for the four). On the f32 FMA units the same work
// takes 0.565 ms even at their peak, so the bf16 mode runs on the tensor
// cores.
//
// Two kernels, chosen by mode and shape in the C launcher below (a dispatch
// on shape: a failed launch still returns its error):
//
// - bf16 mode, every padded width <= 128 (the four flagship chains):
//   mlp_fused_fwd_tc_kernel, mma.sync m16n8k16 bf16 with f32 accumulation
//   (helpers in mma_bf16.cuh). Each warp runs a tile of rows through the
//   whole chain: 32 rows (two m16 tiles, so each B fragment read from
//   shared memory feeds two products; activations of up to 4 k-tiles) when
//   every layer input and the output are at most 64 wide, else 16 rows
//   (up to 8 k-tiles). Either way the activations stay in registers without
//   spills (ptxas: 122 and 114 registers), and a 128-wide f32 output tile
//   staged at 32 rows would take 17 KB of shared memory per warp, leaving
//   one block per SM. The weights are staged once per block into shared memory
//   as bf16, transposed (W^T[n][k]) with K padded to 16 and N to 8 (hidden
//   widths to 16) by zero weights and zero biases, rows 16 bytes apart
//   beyond K so that ldmatrix reads them without bank conflicts; the biases
//   stay f32. x comes in by cp.async, double-buffered per warp, so the next
//   tile's rows are in flight while this one computes; rows whose width is
//   a multiple of 4 land at a padded stride. The f32 accumulator fragment of
//   one layer, after bias, ReLU and rounding to bf16x2, is exactly the A
//   fragment of the next layer, so activations between layers stay in
//   registers. The last layer's f32 fragments are staged through shared
//   memory and written as coalesced rows (float4 where the width allows).
//   The grid is persistent over tiles; ptxas reports no spills.
// - f32 mode, and bf16 chains with a layer wider than 128 (dino_mlp's 256,
//   off on the main path): mlp_fused_fwd_kernel, f32 fused multiply-adds
//   from shared memory. Each thread keeps a 4x4 block of outputs in
//   registers and streams the tile's activations (stored transposed, so a
//   warp's float4 loads are contiguous) and the weights (a broadcast float4
//   per k); the transposed rows are padded by 4 floats; x is read and y
//   written with coalesced accesses. It is bound by its shared-memory
//   traffic.
//
// Numerics. f32 mode: plain f32 fused multiply-adds. bf16 mode follows the
// Pallas kernel's rounding points: x and W_i are rounded to bf16, products
// are accumulated in f32, b_i is added in f32, ReLU, then the activation is
// rounded to bf16 before the next layer; the output is f32. The port's
// plain version (ops/mlp_fused.py::mlp_plain) has the same rounding points.
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------- tensor cores

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMaxWidth = 128;  // widest padded layer the kernel holds
constexpr int kTcMaxPairs = kTcMaxWidth / 16;  // n-tile pairs of the widest output

struct TcDims {
  int num_layers;
  int d[kMaxLayers + 1];   // widths, unpadded
  int kt[kMaxLayers];      // 16-wide k-tiles of layer l's input
  int nt[kMaxLayers];      // 8-wide n-tiles of layer l's output
  int w_off[kMaxLayers];   // bf16 offset of layer l's W^T in shared memory
  int b_off[kMaxLayers];   // float offset of layer l's bias in the bias block
  int w_bytes;             // bytes of all W^T, a multiple of 16
  int b_floats;            // floats of all biases, a multiple of 4
  int xs;                  // float stride of a staged x row (d[0] when d[0] % 4 != 0)
  int x_floats;            // floats of one staged x tile, a multiple of 4
  int ys;                  // float stride of a staged output row
  int warp_floats;         // floats of one warp's staging: two x tiles and the output tile
  uint32_t x_row_magic;    // e * magic >> 20 == e / (d[0] / 4) for the e used
  uint32_t y_magic;        // ... == e / d[last] (or / (d[last] / 4) when d[last] % 4 == 0)
};

__device__ __forceinline__ int fast_div(int e, uint32_t magic) {
  return static_cast<int>((static_cast<uint32_t>(e) * magic) >> 20);
}

// Starts the copy of the `rows_per_tile` rows of x (width d0) of tile `tile`
// into `buf`, each row at a stride of xs floats (zero past row n). xs == d0
// copies the rows as they lie; otherwise d0 is a multiple of 4 and
// x_row_magic divides by d0 / 4.
__device__ __forceinline__ void stage_x(const float* __restrict__ x, int n, int tile,
                                        int rows_per_tile, float* buf, int d0, int xs,
                                        uint32_t x_row_magic, int lane) {
  const int tile_floats = rows_per_tile * d0;
  const int64_t base = static_cast<int64_t>(tile) * tile_floats;
  const int64_t left_in_x = static_cast<int64_t>(n) * d0 - base;
  const int valid = left_in_x < tile_floats ? static_cast<int>(left_in_x) : tile_floats;
  for (int c = lane; c < tile_floats / 4; c += 32) {
    const int left = valid - 4 * c;
    const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
    int dst = 4 * c;
    if (xs != d0) {
      const int r = fast_div(c, x_row_magic);
      dst = r * xs + 4 * c - r * d0;
    }
    umhs::cp_async16(buf + dst, bytes > 0 ? x + base + 4 * c : x, bytes);
  }
}

// Columns c and c + 1 (c even) of staged row r, zero past d0.
__device__ __forceinline__ float2 x_pair(const float* xs, int stride, int d0, int r, int c) {
  if ((stride & 1) == 0)  // d0 is even too, so c < d0 means c + 1 < d0: one 8-byte load
    return c < d0 ? *reinterpret_cast<const float2*>(xs + r * stride + c) : make_float2(0.f, 0.f);
  return make_float2(c < d0 ? xs[r * stride + c] : 0.f, c + 1 < d0 ? xs[r * stride + c + 1] : 0.f);
}

// kKT: 16-wide k-tiles the activations may span (4: layer inputs up to 64
// wide, 8: up to 128). kM: m16 tiles per warp, so a warp's tile is 16 * kM
// rows and each B fragment read from shared memory feeds kM products.
template <int kKT, int kM>
__global__ void __launch_bounds__(kTcThreads)
mlp_fused_fwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ params,
                        float* __restrict__ y, int n, TcDims dims) {
  constexpr int kRows = 16 * kM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* bias = reinterpret_cast<float*>(smem_raw + dims.w_bytes);

  // Stage W_i^T (bf16, zero-padded, row stride K + 8) and b_i (f32) once
  // per block. Global layout is unpadded [W0 (din x dout), b0, W1, b1, ...].
  {
    int goff = 0;
    for (int l = 0; l < dims.num_layers; ++l) {
      const int din = dims.d[l], dout = dims.d[l + 1];
      const int stride = 16 * dims.kt[l] + 8, rows = 8 * dims.nt[l];
      __nv_bfloat16* w = wt + dims.w_off[l];
#pragma unroll 8  // independent loads: keep several in flight
      for (int i = threadIdx.x; i < rows * stride; i += kTcThreads) {
        const int nn = i / stride, k = i - nn * stride;
        w[i] = __float2bfloat16_rn(nn < dout && k < din ? params[goff + k * dout + nn] : 0.f);
      }
      for (int i = threadIdx.x; i < rows; i += kTcThreads)
        bias[dims.b_off[l] + i] = i < dout ? params[goff + din * dout + i] : 0.f;
      goff += din * dout + dout;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  float* xbuf = bias + dims.b_floats + warp * dims.warp_floats;  // two x tiles
  float* ybuf = xbuf + 2 * dims.x_floats;  // the output tile
  const int d0 = dims.d[0], dl = dims.d[dims.num_layers];
  const int num_tiles = (n + kRows - 1) / kRows;
  const int step = gridDim.x * kTcWarps;
  int tile = blockIdx.x * kTcWarps + warp;
  int cur = 0;
  if (tile < num_tiles) stage_x(x, n, tile, kRows, xbuf, d0, dims.xs, dims.x_row_magic, lane);
  umhs::cp_async_commit();

  for (; tile < num_tiles; tile += step) {
    if (tile + step < num_tiles)
      stage_x(x, n, tile + step, kRows, xbuf + (cur ^ 1) * dims.x_floats, d0, dims.xs,
              dims.x_row_magic, lane);
    umhs::cp_async_commit();
    umhs::cp_async_wait<1>();  // this tile's rows have landed
    __syncwarp();

    // A fragments of x, rounded to bf16; columns past d0 are zero.
    const float* xs = xbuf + cur * dims.x_floats;
    uint32_t a[kM][kKT][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        if (kt < dims.kt[0]) {
          const int c = 16 * kt + 2 * tig, r = 16 * mi + gid;
          const float2 p0 = x_pair(xs, dims.xs, d0, r, c);
          const float2 p1 = x_pair(xs, dims.xs, d0, r + 8, c);
          const float2 p2 = x_pair(xs, dims.xs, d0, r, c + 8);
          const float2 p3 = x_pair(xs, dims.xs, d0, r + 8, c + 8);
          a[mi][kt][0] = umhs::pack_bf16x2(p0.x, p0.y);
          a[mi][kt][1] = umhs::pack_bf16x2(p1.x, p1.y);
          a[mi][kt][2] = umhs::pack_bf16x2(p2.x, p2.y);
          a[mi][kt][3] = umhs::pack_bf16x2(p3.x, p3.y);
        }
      }
    }

    for (int l = 0; l < dims.num_layers; ++l) {
      const bool last = l + 1 == dims.num_layers;
      const int kts = dims.kt[l], nts = dims.nt[l];
      const int stride = 16 * kts + 8;
      const __nv_bfloat16* w = wt + dims.w_off[l];
      const float* b = bias + dims.b_off[l];
      uint32_t an[kM][kKT][4];
#pragma unroll
      for (int j = 0; j < kTcMaxPairs; ++j) {  // n-tiles 2j and 2j + 1
        if (2 * j < nts) {
          const bool two = 2 * j + 1 < nts;
          // ldmatrix rows: matrix m = lane / 8 is n-tile 2j + m / 2, k half m % 2
          const int m = two ? lane >> 3 : (lane >> 3) & 1;
          const __nv_bfloat16* wrow = w + (16 * j + 8 * (m >> 1) + (lane & 7)) * stride + 8 * (m & 1);
          float c0[kM][4], c1[kM][4];
#pragma unroll
          for (int mi = 0; mi < kM; ++mi)
#pragma unroll
            for (int q = 0; q < 4; ++q) c0[mi][q] = c1[mi][q] = 0.f;
#pragma unroll
          for (int kt = 0; kt < kKT; ++kt) {
            if (kt < kts) {
              uint32_t bf[4];
              if (two) {
                umhs::ldmatrix_x4(bf, wrow + 16 * kt);
#pragma unroll
                for (int mi = 0; mi < kM; ++mi) {
                  umhs::mma_bf16_16816(c0[mi], a[mi][kt], bf[0], bf[1]);
                  umhs::mma_bf16_16816(c1[mi], a[mi][kt], bf[2], bf[3]);
                }
              } else {
                umhs::ldmatrix_x2(bf, wrow + 16 * kt);
#pragma unroll
                for (int mi = 0; mi < kM; ++mi) umhs::mma_bf16_16816(c0[mi], a[mi][kt], bf[0], bf[1]);
              }
            }
          }
          const int col = 16 * j + 2 * tig;
          const float2 b0 = *reinterpret_cast<const float2*>(b + col);
          const float2 b1 = two ? *reinterpret_cast<const float2*>(b + col + 8) : make_float2(0.f, 0.f);
          if (!last) {
            if (j < kKT) {  // hidden widths are multiples of 16: `two` holds
#pragma unroll
              for (int mi = 0; mi < kM; ++mi) {
                an[mi][j][0] = umhs::pack_bf16x2(fmaxf(c0[mi][0] + b0.x, 0.f), fmaxf(c0[mi][1] + b0.y, 0.f));
                an[mi][j][1] = umhs::pack_bf16x2(fmaxf(c0[mi][2] + b0.x, 0.f), fmaxf(c0[mi][3] + b0.y, 0.f));
                an[mi][j][2] = umhs::pack_bf16x2(fmaxf(c1[mi][0] + b1.x, 0.f), fmaxf(c1[mi][1] + b1.y, 0.f));
                an[mi][j][3] = umhs::pack_bf16x2(fmaxf(c1[mi][2] + b1.x, 0.f), fmaxf(c1[mi][3] + b1.y, 0.f));
              }
            }
          } else {
#pragma unroll
            for (int mi = 0; mi < kM; ++mi) {
              float* yr = ybuf + (16 * mi + gid) * dims.ys + col;
              *reinterpret_cast<float2*>(yr) = make_float2(c0[mi][0] + b0.x, c0[mi][1] + b0.y);
              *reinterpret_cast<float2*>(yr + 8 * dims.ys) =
                  make_float2(c0[mi][2] + b0.x, c0[mi][3] + b0.y);
              if (two) {
                *reinterpret_cast<float2*>(yr + 8) = make_float2(c1[mi][0] + b1.x, c1[mi][1] + b1.y);
                *reinterpret_cast<float2*>(yr + 8 * dims.ys + 8) =
                    make_float2(c1[mi][2] + b1.x, c1[mi][3] + b1.y);
              }
            }
          }
        }
      }
      if (!last) {
#pragma unroll
        for (int mi = 0; mi < kM; ++mi)
#pragma unroll
          for (int kt = 0; kt < kKT; ++kt)
            if (2 * kt < nts)
#pragma unroll
              for (int q = 0; q < 4; ++q) a[mi][kt][q] = an[mi][kt][q];
      }
    }

    __syncwarp();

    // the output tile is row-major and contiguous in y
    const int64_t row0 = static_cast<int64_t>(tile) * kRows;
    const int rows = n - row0 < kRows ? static_cast<int>(n - row0) : kRows;
    float* yt = y + row0 * dl;
    if (dl % 4 == 0) {
      const int q4 = dl / 4;
      for (int v = lane; v < rows * q4; v += 32) {
        const int r = fast_div(v, dims.y_magic);
        *reinterpret_cast<float4*>(yt + 4 * v) =
            *reinterpret_cast<const float4*>(ybuf + r * dims.ys + 4 * (v - r * q4));
      }
    } else {
      for (int e = lane; e < rows * dl; e += 32) {
        const int r = fast_div(e, dims.y_magic);
        yt[e] = ybuf[r * dims.ys + e - r * dl];
      }
    }
    __syncwarp();  // the buffers are free for the copy two tiles on
    cur ^= 1;
  }
  umhs::cp_async_wait<0>();
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

uint32_t magic_for(int divisor) { return ((1u << 20) + divisor - 1) / divisor; }

// Fills `td` and the shared-memory bytes of the tensor-core kernel for
// tiles of `rows` rows per warp; false when a padded width exceeds
// kTcMaxWidth or the block does not fit.
bool tc_dims(const int* d, int num_layers, int rows, TcDims& td, size_t& smem) {
  td = TcDims{};
  td.num_layers = num_layers;
  int w_elems = 0, b_floats = 0;
  for (int l = 0; l <= num_layers; ++l) td.d[l] = d[l];
  for (int l = 0; l < num_layers; ++l) {
    const int kp = round_up(d[l], 16);
    const int np = l + 1 == num_layers ? round_up(d[l + 1], 8) : round_up(d[l + 1], 16);
    if (kp > kTcMaxWidth || np > kTcMaxWidth) return false;
    td.kt[l] = kp / 16;
    td.nt[l] = np / 8;
    td.w_off[l] = w_elems;
    td.b_off[l] = b_floats;
    w_elems += np * (kp + 8);  // a multiple of 8 bf16: offsets stay 16-byte aligned
    b_floats += np;
  }
  td.w_bytes = round_up(2 * w_elems, 16);
  td.b_floats = round_up(b_floats, 4);
  const int d0 = d[0], dl = d[num_layers];
  // rows of a width that is a multiple of 4 land at a stride of 8 (mod 32)
  // floats: the A-fragment loads of a half-warp then fall on distinct banks
  td.xs = d0 % 4 == 0 ? round_up(d0, 32) + 8 : d0;
  td.x_floats = round_up(rows * td.xs, 4);
  td.ys = round_up(round_up(dl, 8), 32) + 8;
  td.warp_floats = 2 * td.x_floats + rows * td.ys;
  td.x_row_magic = magic_for(std::max(d0 / 4, 1));
  td.y_magic = magic_for(dl % 4 == 0 ? dl / 4 : dl);
  smem = static_cast<size_t>(td.w_bytes) + sizeof(float) * (td.b_floats +
         static_cast<size_t>(kTcWarps) * td.warp_floats);
  return smem <= static_cast<size_t>(kSmemLimit);
}

template <int kKT, int kM>
cudaError_t launch_tc(const float* x, const float* params, float* y, int n,
                      const TcDims& td, size_t smem, cudaStream_t stream) {
  auto kernel = mlp_fused_fwd_tc_kernel<kKT, kM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + 16 * kM - 1) / (16 * kM);
  const int blocks = (tiles + kTcWarps - 1) / kTcWarps;
  const int grid = std::min(blocks, std::max(per_sm, 1) * umhs::num_sms());
  kernel<<<grid, kTcThreads, smem, stream>>>(x, params, y, n, td);
  return cudaGetLastError();
}

}  // namespace

// x: (n, dims[0]) f32; params: [W0, b0, W1, b1, ...] f32 with W_i row-major
// (dims[i], dims[i+1]); y: (n, dims[num_layers]) f32; x and y 16-byte
// aligned. Returns a cudaError_t.
extern "C" int umhs_mlp_fused_fwd(const float* x, const float* params, float* y,
                                  const int* dims_host, int num_layers, int n,
                                  int bf16, void* stream) {
  if (num_layers < 1 || num_layers > kMaxLayers || n < 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorMisalignedAddress;
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
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    // 32 rows per warp and activations of up to 4 k-tiles when the layer
    // inputs and the output are at most 64 wide; else 16 rows and up to 8
    int widest = dims_host[num_layers];
    for (int l = 0; l < num_layers; ++l) widest = std::max(widest, dims_host[l]);
    const bool narrow = widest <= 64;
    TcDims td;
    size_t smem = 0;
    if (tc_dims(dims_host, num_layers, narrow ? 32 : 16, td, smem))
      return narrow ? launch_tc<4, 2>(x, params, y, n, td, smem, s)
                    : launch_tc<8, 1>(x, params, y, n, td, smem, s);
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
  return bf16 ? launch<true>(x, params, y, n, dims, smem, s)
              : launch<false>(x, params, y, n, dims, smem, s);
}
