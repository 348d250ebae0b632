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
// Three fused kernels, the fused route and the general route, chosen by
// mode and shape in the C launcher below (a dispatch on shape: a failed
// launch still returns its error; the launcher reports the route it took):
//
// - bf16 mode, every padded width <= 128 (the four flagship chains):
//   mlp_fused_fwd_tc_kernel, mma.sync m16n8k16 bf16 with f32 accumulation
//   (helpers in mma_bf16.cuh; the chain itself, staging of weights and x
//   and the layer loop, in mlp_chain_tc.cuh, where K2's recompute runs the
//   same code). Each warp runs a tile of rows through the
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
// - bf16 mode, one or two layers with a padded width above 128 and none
//   above 256 (dino_mlp's 15 -> 256 -> 128): mlp_fused_fwd_wide_kernel. A
//   256-wide activation as A fragments would take 64 registers a thread and
//   the next layer's another 64, so each warp keeps its 16 rows' bf16 layer
//   input in shared memory (a 16 x 264 bf16 buffer for the DINO chain's
//   hidden layer) and pairs_product (mlp_chain_tc.cuh) reads one A fragment
//   per k-tile by ldmatrix for four n-tile pairs (64 output columns) at a
//   time; the weights, bf16 W^T (80 KB for the DINO chain against 148 KB in
//   f32), are staged once per block, and as many warps as the shared memory
//   then holds (16 for the DINO chain) share them. The last layer's sums,
//   biased, go to y straight from the fragments as f32 pairs (each quad of
//   lanes writes 32 whole bytes of a row). What bounds it: the DINO chain at
//   262,144 rows writes 134 MB of y (0.045 ms at 3.35 TB/s) for ~19 GFLOP
//   of tensor-core work (0.02 ms); the kernel reads each B fragment from
//   shared memory once per 16 rows, so ldmatrix traffic and the latency of
//   one warp's mma chain, not the bytes, set its time. Three-layer and
//   deeper chains wider than 128 stay on the FMA kernel, because K2's wide
//   kernel takes two layers and K2 must recompute with K1's arithmetic.
// - f32 mode, and bf16 chains neither tensor-core kernel takes (three or
//   more layers with a width above 128): mlp_fused_fwd_kernel, f32 fused
//   multiply-adds from shared memory. Each thread keeps a 4x4 block of outputs in
//   registers and streams the tile's activations (stored transposed, so a
//   warp's float4 loads are contiguous) and the weights (a broadcast float4
//   per k); the transposed rows are padded by 4 floats; x is read and y
//   written with coalesced accesses. It is bound by its shared-memory
//   traffic.
// - every other chain (a width above 256, more than 8 layers, or no room for
//   either FMA kernel): in bf16 the fused route of mlp_chain_fused.cuh
//   (mlp_chain_fwd_kernel: the whole chain in one launch, where its hidden
//   widths are at most 256 and its tiles fit), else the general route of
//   mlp_general.cuh (a product per layer; bf16 on wgmma fed by TMA).
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
#include "mlp_chain_tc.cuh"
#include "mlp_chain_fused.cuh"
#include "mlp_general.cuh"

namespace {

constexpr int kMaxLayers = umhs::kFusedMaxLayers;  // the FMA kernel's; deeper chains go general
constexpr int kThreads = 256;
constexpr int kRB = 4;  // rows per thread
constexpr int kCB = 4;  // columns per thread
constexpr int kSmemLimit = umhs::kFusedSmemLimit;

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

struct TcDims {
  umhs::TcChain c;         // the chain's weights in shared memory (mlp_chain_tc.cuh)
  int xs;                  // float stride of a staged x row (d[0] when d[0] % 4 != 0)
  int x_floats;            // floats of one staged x tile, a multiple of 4
  int ys;                  // float stride of a staged output row
  int warp_floats;         // floats of one warp's staging: two x tiles and the output tile
  uint32_t x_row_magic;    // e * magic >> 20 == e / (d[0] / 4) for the e used
  uint32_t y_magic;        // ... == e / d[last] (or / (d[last] / 4) when d[last] % 4 == 0)
};

// The last layer's fragments, biased, into the warp's output tile.
template <int kM>
struct StageOutput {
  float* ybuf;
  int ys, gid, tig;
  __device__ __forceinline__ void output(int j, bool two, const float (&c0)[kM][4],
                                         const float (&c1)[kM][4], float2 b0, float2 b1) {
    const int col = 16 * j + 2 * tig;
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      float* yr = ybuf + (16 * mi + gid) * ys + col;
      *reinterpret_cast<float2*>(yr) = make_float2(c0[mi][0] + b0.x, c0[mi][1] + b0.y);
      *reinterpret_cast<float2*>(yr + 8 * ys) = make_float2(c0[mi][2] + b0.x, c0[mi][3] + b0.y);
      if (two) {
        *reinterpret_cast<float2*>(yr + 8) = make_float2(c1[mi][0] + b1.x, c1[mi][1] + b1.y);
        *reinterpret_cast<float2*>(yr + 8 * ys + 8) =
            make_float2(c1[mi][2] + b1.x, c1[mi][3] + b1.y);
      }
    }
  }
  template <int kKT>
  __device__ __forceinline__ void hidden(int, const uint32_t (&)[kM][kKT][4]) {}
};

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
  float* bias = reinterpret_cast<float*>(smem_raw + dims.c.w_bytes);
  umhs::stage_chain_weights<kTcThreads>(dims.c, dims.c.num_layers, params, wt, bias);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xbuf = bias + dims.c.b_floats + warp * dims.warp_floats;  // two x tiles
  float* ybuf = xbuf + 2 * dims.x_floats;  // the output tile
  const int d0 = dims.c.d[0], dl = dims.c.d[dims.c.num_layers];
  const int num_tiles = (n + kRows - 1) / kRows;
  const int step = gridDim.x * kTcWarps;
  int tile = blockIdx.x * kTcWarps + warp;
  int cur = 0;
  if (tile < num_tiles)
    umhs::stage_rows(x, n, tile, kRows, xbuf, d0, dims.xs, dims.x_row_magic, lane);
  umhs::cp_async_commit();
  StageOutput<kM> out{ybuf, dims.ys, lane >> 2, lane & 3};

  for (; tile < num_tiles; tile += step) {
    if (tile + step < num_tiles)
      umhs::stage_rows(x, n, tile + step, kRows, xbuf + (cur ^ 1) * dims.x_floats, d0, dims.xs,
                       dims.x_row_magic, lane);
    umhs::cp_async_commit();
    umhs::cp_async_wait<1>();  // this tile's rows have landed
    __syncwarp();

    uint32_t a[kM][kKT][4];
    umhs::x_fragments<kKT, kM>(a, xbuf + cur * dims.x_floats, dims.xs, d0, dims.c.kt[0], lane);
    umhs::chain_forward<kKT, kM>(a, dims.c, wt, bias, dims.c.num_layers, lane, out);
    __syncwarp();

    // the output tile is row-major and contiguous in y
    const int64_t row0 = static_cast<int64_t>(tile) * kRows;
    const int rows = n - row0 < kRows ? static_cast<int>(n - row0) : kRows;
    float* yt = y + row0 * dl;
    if (dl % 4 == 0) {
      const int q4 = dl / 4;
      for (int v = lane; v < rows * q4; v += 32) {
        const int r = umhs::fast_div(v, dims.y_magic);
        *reinterpret_cast<float4*>(yt + 4 * v) =
            *reinterpret_cast<const float4*>(ybuf + r * dims.ys + 4 * (v - r * q4));
      }
    } else {
      for (int e = lane; e < rows * dl; e += 32) {
        const int r = umhs::fast_div(e, dims.y_magic);
        yt[e] = ybuf[r * dims.ys + e - r * dl];
      }
    }
    __syncwarp();  // the buffers are free for the copy two tiles on
    cur ^= 1;
  }
  umhs::cp_async_wait<0>();
}

// Fills `td` and the shared-memory bytes of the tensor-core kernel for
// tiles of `rows` rows per warp; false when a padded width exceeds
// kChainMaxWidth or the block does not fit.
bool tc_dims(const int* d, int num_layers, int rows, TcDims& td, size_t& smem) {
  using umhs::round_up;
  td = TcDims{};
  if (!umhs::tc_chain(d, num_layers, td.c)) return false;
  const int d0 = d[0], dl = d[num_layers];
  // rows of a width that is a multiple of 4 land at a stride of 8 (mod 32)
  // floats: the A-fragment loads of a half-warp then fall on distinct banks
  td.xs = d0 % 4 == 0 ? round_up(d0, 32) + 8 : d0;
  td.x_floats = round_up(rows * td.xs, 4);
  td.ys = round_up(round_up(dl, 8), 32) + 8;
  td.warp_floats = 2 * td.x_floats + rows * td.ys;
  td.x_row_magic = umhs::magic_for(std::max(d0 / 4, 1));
  td.y_magic = umhs::magic_for(dl % 4 == 0 ? dl / 4 : dl);
  smem = static_cast<size_t>(td.c.w_bytes) + sizeof(float) * (td.c.b_floats +
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

// -------------------------------------------- tensor cores, wider than 128

constexpr int kWideMaxWarps = 16;

struct WideDims {
  umhs::TcChain c;  // W^T and b of every layer, every output padded to 16 (two n-tiles)
  int warps;        // warps per block: as many as the shared memory holds, at most 16
  int buf_elems[2]; // bf16 elements of a warp's two activation buffers (even, odd layers' inputs)
};

// One warp per 16-row tile, persistent over tiles. Each layer's bf16 input
// lies in the warp's buffer of its parity; pairs_product takes 64 output
// columns at a time. A hidden layer's sums, biased, ReLU'd and rounded to
// bf16, go into the other buffer; the last layer's, biased, to y as f32
// pairs straight from the fragments (each quad of lanes writes 32 whole
// bytes of a row).
__global__ void __launch_bounds__(32 * kWideMaxWarps)
mlp_fused_fwd_wide_kernel(const float* __restrict__ x, const float* __restrict__ params,
                          float* __restrict__ y, int n, WideDims dims) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const umhs::TcChain& c = dims.c;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* bias = reinterpret_cast<float*>(smem_raw + c.w_bytes);
  umhs::stage_wide_weights(c, params, wt, bias);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* const buf0 = reinterpret_cast<__nv_bfloat16*>(bias + c.b_floats) +
                             warp * (dims.buf_elems[0] + dims.buf_elems[1]);
  __nv_bfloat16* const buf1 = buf0 + dims.buf_elems[0];
  const int L = c.num_layers, d0 = c.d[0], dl = c.d[L];
  const int num_tiles = (n + 15) / 16;
  for (int tile = blockIdx.x * dims.warps + warp; tile < num_tiles;
       tile += gridDim.x * dims.warps) {
    const int64_t row0 = static_cast<int64_t>(tile) * 16;
    umhs::stage_x_bf16(x, n, row0, 16, d0, 16 * c.kt[0], buf0, 16 * c.kt[0] + 8, lane);
    __syncwarp();
    for (int l = 0; l < L; ++l) {
      const int kts = c.kt[l], as = 16 * kts + 8, pairs = c.nt[l] / 2;
      const bool last = l + 1 == L;
      const __nv_bfloat16* in = l & 1 ? buf1 : buf0;
      __nv_bfloat16* out = l & 1 ? buf0 : buf1;
      const int os = last ? 0 : 16 * c.kt[l + 1] + 8;
      const float* b = bias + c.b_off[l];
      for (int p0 = 0; p0 < pairs; p0 += 4) {
        float acc[4][2][4];
        umhs::pairs_product<4>(acc, in, as, wt + c.w_off[l] + 16 * p0 * as, as,
                               min(4, pairs - p0), kts, lane);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = 16 * (p0 + p) + 8 * h + 2 * tig;
            if (p0 + p >= pairs) continue;
            const float2 bv = *reinterpret_cast<const float2*>(b + col);
            const float* v = acc[p][h];
            if (!last) {
              *reinterpret_cast<uint32_t*>(out + gid * os + col) =
                  umhs::pack_bf16x2(fmaxf(v[0] + bv.x, 0.f), fmaxf(v[1] + bv.y, 0.f));
              *reinterpret_cast<uint32_t*>(out + (gid + 8) * os + col) =
                  umhs::pack_bf16x2(fmaxf(v[2] + bv.x, 0.f), fmaxf(v[3] + bv.y, 0.f));
            } else if (col < dl) {
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int64_t row = row0 + gid + 8 * half;
                if (row >= n) continue;
                float* yr = y + row * dl + col;
                const float a0 = v[2 * half] + bv.x, a1 = v[2 * half + 1] + bv.y;
                if ((dl & 1) == 0) {
                  *reinterpret_cast<float2*>(yr) = make_float2(a0, a1);
                } else {
                  yr[0] = a0;
                  if (col + 1 < dl) yr[1] = a1;
                }
              }
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// Fills `wd` and the shared-memory bytes of the wide kernel; false when the
// chain is not one it takes: more than two layers (K2's wide kernel takes
// two, and K2 must recompute with K1's arithmetic), a padded width above
// 256, or weights that leave no room for one warp.
bool wide_dims(const int* d, int num_layers, WideDims& wd, size_t& smem) {
  wd = WideDims{};
  if (num_layers > 2 ||
      !umhs::tc_chain(d, num_layers, wd.c, umhs::kWideMaxWidth, 16))
    return false;
  for (int l = 0; l < num_layers; ++l) {
    const int elems = 16 * (16 * wd.c.kt[l] + 8);
    wd.buf_elems[l & 1] = std::max(wd.buf_elems[l & 1], elems);
  }
  const size_t weights = static_cast<size_t>(wd.c.w_bytes) + sizeof(float) * wd.c.b_floats;
  const size_t per_warp = 2 * static_cast<size_t>(wd.buf_elems[0] + wd.buf_elems[1]);
  if (weights + per_warp > static_cast<size_t>(kSmemLimit)) return false;
  wd.warps = static_cast<int>(std::min<size_t>(kWideMaxWarps,
                                               (kSmemLimit - weights) / per_warp));
  smem = weights + wd.warps * per_warp;
  return true;
}

cudaError_t launch_wide(const float* x, const float* params, float* y, int n,
                        const WideDims& wd, size_t smem, cudaStream_t stream) {
  auto kernel = mlp_fused_fwd_wide_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int threads = 32 * wd.warps;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + 15) / 16;
  const int blocks = (tiles + wd.warps - 1) / wd.warps;
  const int grid = std::min(blocks, std::max(per_sm, 1) * umhs::num_sms());
  kernel<<<grid, threads, smem, stream>>>(x, params, y, n, wd);
  return cudaGetLastError();
}

// The bf16 route of the chain d[0..num_layers]: 100 kKT + kM for
// mlp_fused_fwd_tc_kernel<kKT, kM> (32 rows per warp and activations of up
// to 4 k-tiles when the layer inputs and the output are at most 64 wide,
// else 16 rows and up to 8), 1 for mlp_fused_fwd_wide_kernel, 0 for the FMA
// kernel; fills the dims and shared-memory bytes of the kernel it names.
int bf16_route(const int* d, int num_layers, TcDims& td, WideDims& wd, size_t& smem) {
  int widest = d[num_layers];
  for (int l = 0; l < num_layers; ++l) widest = std::max(widest, d[l]);
  const bool narrow = widest <= 64;
  if (tc_dims(d, num_layers, narrow ? 32 : 16, td, smem)) return narrow ? 402 : 801;
  if (wide_dims(d, num_layers, wd, smem)) return 1;
  return 0;
}

// Where a chain goes that no kernel above takes: 3, the fused route
// (mlp_chain_fused.cuh), for a bf16 chain it takes; else 2, the general
// route (mlp_general.cuh). K2's launcher applies the same rule.
int past_the_fused_kernels(const int* d, int num_layers, bool bf16) {
  return bf16 && umhs::chain::chain_fits(d, num_layers) ? 3 : 2;
}

// The route of the chain d[0..num_layers] in this mode: 100 kKT + kM for
// mlp_fused_fwd_tc_kernel<kKT, kM>, 1 for mlp_fused_fwd_wide_kernel, 0 for
// the FMA kernel, 2 for the general route, 3 for the fused route; -1 for a
// chain it refuses (a width below 1). Fills the dims and shared-memory
// bytes of the tensor-core kernel it names.
int route_of(const int* d, int num_layers, bool bf16, TcDims& td, WideDims& wd, size_t& smem) {
  if (num_layers < 1) return -1;
  for (int l = 0; l <= num_layers; ++l)
    if (d[l] < 1) return -1;
  if (!umhs::fused_shape(d, num_layers)) return past_the_fused_kernels(d, num_layers, bf16);
  if (bf16) {
    const int r = bf16_route(d, num_layers, td, wd, smem);
    if (r != 0) return r;
  }
  return umhs::fma_takes(d, num_layers) ? 0 : past_the_fused_kernels(d, num_layers, bf16);
}

// The index of a route code among the wrapper's names (MLP_FWD_ROUTES).
int route_index(int code, bool bf16) {
  switch (code) {
    case 0: return bf16 ? 1 : 0;
    case 402: return 2;
    case 801: return 3;
    case 1: return 4;
    case 3: return 7;
    default: return bf16 ? 6 : 5;
  }
}

}  // namespace

// x: (n, dims[0]) f32; params: [W0, b0, W1, b1, ...] f32 with W_i row-major
// (dims[i], dims[i+1]); y: (n, dims[num_layers]) f32; x and y 16-byte
// aligned; scratch: umhs_mlp_fused_fwd_scratch_bytes(...) bytes of device
// memory, 256-byte aligned (null where that is 0). Writes the route it took
// (its index among the wrapper's route names) to *route. Returns a
// cudaError_t.
extern "C" int umhs_mlp_fused_fwd(const float* x, const float* params, float* y,
                                  const int* dims_host, int num_layers, int n, int bf16,
                                  void* scratch, int64_t scratch_bytes, void* stream,
                                  int32_t* route) {
  TcDims td;
  WideDims wd;
  size_t tc_smem = 0;
  const int code = route_of(dims_host, num_layers, bf16 != 0, td, wd, tc_smem);
  if (code < 0 || n < 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorMisalignedAddress;
  *route = route_index(code, bf16 != 0);
  if (n == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 402: return launch_tc<4, 2>(x, params, y, n, td, tc_smem, s);
    case 801: return launch_tc<8, 1>(x, params, y, n, td, tc_smem, s);
    case 1: return launch_wide(x, params, y, n, wd, tc_smem, s);
    case 2: {
      const size_t need = umhs::general::fwd_scratch_bytes(dims_host, num_layers, bf16 != 0, n);
      if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 256 != 0 ||
          scratch_bytes < static_cast<int64_t>(need))
        return cudaErrorInvalidValue;
      return bf16 ? umhs::general::forward<__nv_bfloat16>(x, params, y, n, dims_host, num_layers,
                                                          scratch, s)
                  : umhs::general::forward<float>(x, params, y, n, dims_host, num_layers,
                                                  scratch, s);
    }
    case 3: {
      const size_t need = umhs::chain::fwd_scratch_bytes(dims_host, num_layers);
      if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 256 != 0 ||
          scratch_bytes < static_cast<int64_t>(need))
        return cudaErrorInvalidValue;
      return umhs::chain::forward(x, params, y, n, dims_host, num_layers, scratch, s);
    }
    default: break;
  }
  Dims dims{};
  dims.num_layers = num_layers;
  for (int l = 0; l <= num_layers; ++l) {
    dims.d[l] = dims_host[l];
    dims.max_width4 = std::max(dims.max_width4, round4(dims_host[l]));
    if (l > 0) dims.param_floats += dims_host[l - 1] * round4(dims_host[l]) + round4(dims_host[l]);
  }
  // Largest tile that leaves room for two blocks per SM (else for one):
  // 128 rows make a warp's 32 row groups share one weight column block
  // (broadcast loads); wider chains take fewer rows.
  size_t smem = 0;
  dims.tile_rows = umhs::fma_fwd_tile(dims_host, num_layers, &smem);
  dims.stride = dims.tile_rows + 4;
  return bf16 ? launch<true>(x, params, y, n, dims, smem, s)
              : launch<false>(x, params, y, n, dims, smem, s);
}

// The kernel umhs_mlp_fused_fwd runs for the chain dims[0..num_layers] in
// this mode: 100 kKT + kM for mlp_fused_fwd_tc_kernel<kKT, kM>, 1 for
// mlp_fused_fwd_wide_kernel, 0 for the FMA kernel, 2 for the general route,
// 3 for the fused route; -1 for a chain it refuses.
extern "C" int umhs_mlp_fused_fwd_route(const int* dims_host, int num_layers, int bf16) {
  TcDims td;
  WideDims wd;
  size_t smem = 0;
  return route_of(dims_host, num_layers, bf16 != 0, td, wd, smem);
}

// Bytes of scratch umhs_mlp_fused_fwd needs for n rows of the chain in this
// mode: the general route's packed weights and activations, the fused
// route's packed weights, else 0.
extern "C" int64_t umhs_mlp_fused_fwd_scratch_bytes(const int* dims_host, int num_layers,
                                                    int bf16, int64_t n) {
  const int route = umhs_mlp_fused_fwd_route(dims_host, num_layers, bf16);
  if (route == 3) return static_cast<int64_t>(umhs::chain::fwd_scratch_bytes(dims_host, num_layers));
  if (route != 2 || n <= 0) return 0;
  return static_cast<int64_t>(
      umhs::general::fwd_scratch_bytes(dims_host, num_layers, bf16 != 0, n));
}
