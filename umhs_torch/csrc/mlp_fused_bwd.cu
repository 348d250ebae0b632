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
// 100-700 bytes of x, g and dx per row. On the tensor cores that work is
// small, so an ideal kernel is bound by bytes: 0.112 ms for the four field
// chains at 262,144 rows (x and g read once, dx written once, at 3.35 TB/s).
//
// Three fused kernels, the fused route and the general route, chosen by
// mode and shape in the C launcher below (a dispatch on shape: a failed
// launch still returns its error, nothing falls back from one kernel to
// another, and the launcher reports the route it took):
//
// - bf16 mode, every padded width <= 128 and at most 16 dW tiles per warp
//   (8 where a width exceeds 64; the four field chains, the proposal chain):
//   mlp_fused_bwd_tc_kernel, mma.sync m16n8k16 bf16 with f32 sums. A block
//   of 4 warps takes 64 rows at a time, 16 per warp, and walks its tiles
//   persistently. The recompute is K1's own chain (mlp_chain_tc.cuh), so
//   every activation, and every ReLU decision, is the forward's bit for bit;
//   it stores each layer's bf16 input a_l into the block's tile area in
//   shared memory. dh then stays in registers from layer to layer: the f32
//   C fragments of dh . W^T, gated by a_l > 0 and packed to bf16x2, are the
//   A fragments of the next product, whose B operand is W itself, staged
//   once per block as bf16 in its row-major layout. db is a warp reduction of
//   the gated f32 dh (shuffles over the row groups into lanes 0-3, added to
//   the warp's own column sums in shared memory). Each dh_l, bf16, also goes
//   into the tile area; after one block barrier, dW = a^T . dh sums over the
//   block's 64 rows with both operands read by ldmatrix.trans. Every warp
//   owns a fixed set of the chain's m16n8 dW tiles and keeps their f32 sums in
//   registers across the block's tiles, so no sum is ever added atomically
//   (feature_mlp: 52 tiles, 13 a warp). x and g come in by cp.async,
//   double-buffered per warp; dx is staged in the warp's x buffer and
//   written as coalesced rows (float4 where the width allows), and skipped
//   when not wanted. At the end each block writes its dW and db to its row of
//   partials.
// - bf16 mode, two layers, padded widths up to 256 (dino_mlp's 15 -> 256 ->
//   128): mlp_fused_bwd_wide_kernel. Here the dW tiles do not fit the
//   registers of a block (the DINO chain has 32 + 256 m16n8 tiles), so the
//   hidden width is cut into slices of 64 columns (32 or 16 where the output
//   is wider), one per block row of the grid (blockIdx.y). For a two-layer
//   chain a slice is independent of the others: it needs x, g, W0[:, c],
//   b0[c] and W1[c, :], and owns dW0[:, c], db0[c] and dW1[c, :] (slice 0
//   also db1), so nothing is computed twice; only dx, a sum over slices,
//   goes through per-slice partials that a second pass adds in slice order.
//   What bounds it: at the DINO chain's 262,144 rows the tensor-core work
//   (about 39 GFLOP as the kernel does it) is ~0.04 ms at the bf16 peak and
//   the bytes (x and g once, 150 MB) ~0.05 ms; each slice reads x and g
//   again, from L2 where the four slices of a row block run together (the
//   grid holds every block at once). The kernel itself is bound by the
//   latency of its mma.sync chains: one block of 8 warps fits an SM (180 KB
//   of shared memory, ~220 registers a thread). What the design does about
//   it: the next tile's x and g rows come in by cp.async during this tile's
//   work; each k-tile's A fragment feeds 8 products (pairs_product, shared
//   with K1) with every B fragment loaded before the first; in the dW
//   phase a warp owns 9 neighbouring tiles (in (layer, m-tile, n-tile)
//   order) and reads their shared A fragments once. The recompute of
//   a1[:, c] runs K1's wide arithmetic (pairs_product over the same
//   k-tiles in the same order from zero), so each ReLU decision is K1's.
// - f32 mode, and chains neither tensor-core kernel takes (three or more
//   layers with a width above 128): mlp_fused_bwd_kernel, f32 fused
//   multiply-adds from shared memory. Each thread keeps a 4x4 block of
//   outputs in registers; activations and dh are stored transposed
//   (feature-major, rows padded by 4 floats) so the row-blocked products read
//   float4s along rows, and the dW product has each thread own rows i,
//   i + D/4, i + 2D/4, i + 3D/4 so a warp's float4 reads fall in distinct
//   banks. It is bound by its shared-memory traffic.
// - every other chain (as K1's rule: a width above 256, more than 8
//   layers, or no room for either FMA kernel): in bf16 the fused route of
//   mlp_chain_fused.cuh where K1 takes it (mlp_chain_bwd_kernel: one launch
//   over fixed row ranges, recomputing with K1's fused code, dW and db
//   summed a range a block, then over the blocks in order), else the general
//   route of mlp_general.cuh. That one recomputes each layer's input with
//   K1's general products into a device scratch, walks the layers back with
//   a product per step, and sums dW and db from per-block partials in block
//   order, then chunk order (umhs_mlp_fused_bwd_scratch_bytes sizes either
//   route's buffers; the general route's by layer: the largest layer's
//   partials, reused).
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
constexpr int kSmemLimit = umhs::kFusedSmemLimit;

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

// ---------------------------------------------------------------- tensor cores

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;  // rows of a block's tile: 16 per warp

struct TcBwdDims {
  umhs::TcChain c;          // W^T and b of the recompute (layers 0 .. L-2), as K1 stages them
  int nk[kMaxLayers];       // 16-wide k-tiles of dh_l: layer l's output width padded to 16
  int wb_off[kMaxLayers];   // bf16 offset of W_l in the W block: 16 kt[l] rows of 16 nk[l] + 8
  int act_off[kMaxLayers];  // bf16 offset of a_l in the tile area: kTcRows rows of 16 kt[l] + 8
  int dh_off[kMaxLayers];   // ... of dh_l: kTcRows rows of 16 nk[l] + 8
  int goff[kMaxLayers];     // float offset of W_l in params (b_l follows it)
  int db_off[kMaxLayers];   // float offset of db_l in a warp's column sums
  int dw_nt[kMaxLayers];    // 8-wide n-tiles of dW_l (its 16-row m-tiles are c.kt[l])
  int wb_bytes;             // bytes of W^T and W together, a multiple of 16
  int tile_bytes;           // bytes of the tile area, a multiple of 16
  int db_floats;            // floats of one warp's column sums, a multiple of 4
  int param_floats;         // unpadded weights + biases (global layout)
  int xs, x_floats;         // staged x: float stride of a row, floats of a 16-row tile
  int gs, g_floats;         // staged g: likewise
  uint32_t x_row_magic, g_row_magic, dx_magic;
};

// A fragment's four registers at k-tile kt of a row-major bf16 area (row
// stride s, a multiple of 8) for the lane at row `row` (and row + 8), column
// 2 tig: (row, c), (row + 8, c), (row, c + 8), (row + 8, c + 8), c = 16 kt + 2 tig.
__device__ __forceinline__ uint32_t* frag_at(__nv_bfloat16* area, int s, int row, int tig,
                                             int kt) {
  return reinterpret_cast<uint32_t*>(area + row * s + 16 * kt + 2 * tig);
}

__device__ __forceinline__ void store_frag(__nv_bfloat16* area, int s, int row, int tig, int kt,
                                           const uint32_t (&f)[4]) {
  uint32_t* p = frag_at(area, s, row, tig, kt);
  p[0] = f[0];
  p[4 * s] = f[1];
  p[4] = f[2];
  p[4 * s + 4] = f[3];
}

// v where the bf16 post-activation (the low or high half of `post`) is > 0, else 0.
__device__ __forceinline__ float gate(uint32_t post, int half, float v) {
  return static_cast<int16_t>(post >> (16 * half)) > 0 ? v : 0.f;
}

// Sums s0 and s1 over the warp's eight row groups (lane / 4) and adds them
// to db[0] and db[1] in lanes 0-3, which own columns 2 lane and 2 lane + 1.
__device__ __forceinline__ void col_sums(float* db, float s0, float s1, int lane) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (lane < 4) {
    db[0] += s0;
    db[1] += s1;
  }
}

// The recompute's hook (mlp_chain_tc.cuh): each layer's input a_l, bf16,
// into this warp's rows of the tile area.
struct StoreInputs {
  const TcBwdDims& d;
  __nv_bfloat16* area;
  int row, tig;
  template <int kKT>
  __device__ __forceinline__ void hidden(int l, const uint32_t (&a)[1][kKT][4]) {
    const int s = 16 * d.c.kt[l] + 8;
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt)
      if (kt < d.c.kt[l]) store_frag(area + d.act_off[l], s, row, tig, kt, a[0][kt]);
  }
  __device__ __forceinline__ void output(int, bool, const float (&)[1][4], const float (&)[1][4],
                                         float2, float2) {}
};

// kKT: 16-wide k-tiles the activations and gradients may span (4: every
// width up to 64; 8: up to 128). kOwn: dW tiles a warp may own.
template <int kKT, int kOwn>
__global__ void __launch_bounds__(kTcThreads)
mlp_fused_bwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ g,
                        const float* __restrict__ params, float* __restrict__ dx,
                        float* __restrict__ partials, int n, TcBwdDims dims) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const umhs::TcChain& c = dims.c;
  const int L = c.num_layers, d0 = c.d[0], dl = c.d[L];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(smem_raw + c.w_bytes);
  float* bias = reinterpret_cast<float*>(smem_raw + dims.wb_bytes);
  __nv_bfloat16* area = reinterpret_cast<__nv_bfloat16*>(bias + c.b_floats);
  const int warp_floats = 2 * dims.x_floats + 2 * dims.g_floats;
  float* bufs = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(area) + dims.tile_bytes);
  float* dbs = bufs + kTcWarps * warp_floats;

  // W^T and b of the recompute, W of every layer (row-major as in params:
  // the B operand of dh . W^T), and zeroed column sums; once per block.
  umhs::stage_chain_weights<kTcThreads>(c, L - 1, params, wt, bias);
  for (int l = 0; l < L; ++l) {
    const int din = c.d[l], dout = c.d[l + 1];
    const int stride = 16 * dims.nk[l] + 8, rows = 16 * c.kt[l];
    const float* src = params + dims.goff[l];
    __nv_bfloat16* w = wb + dims.wb_off[l];
#pragma unroll 8
    for (int i = threadIdx.x; i < rows * stride; i += kTcThreads) {
      const int r = i / stride, col = i - r * stride;
      w[i] = __float2bfloat16_rn(r < din && col < dout ? src[r * dout + col] : 0.f);
    }
  }
  for (int i = threadIdx.x; i < kTcWarps * dims.db_floats; i += kTcThreads) dbs[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row = 16 * warp + gid;  // this lane's first row in the tile area
  float* xbuf = bufs + warp * warp_floats;  // two x tiles, then two g tiles
  float* gbuf = xbuf + 2 * dims.x_floats;
  float* dbw = dbs + warp * dims.db_floats;

  // The dW tiles this warp owns, for every tile of rows the block walks: tile
  // warp + kTcWarps t in the order (layer, 16-row m-tile, 8-wide n-tile),
  // packed as l | m << 4 | n << 12 (~0: none); their sums stay in registers.
  uint32_t own[kOwn];
  float acc[kOwn][4];
#pragma unroll
  for (int t = 0; t < kOwn; ++t) {
    int tt = warp + kTcWarps * t, l = 0;
    for (; l < L; ++l) {
      const int count = c.kt[l] * dims.dw_nt[l];
      if (tt < count) break;
      tt -= count;
    }
    own[t] = l < L ? l | (tt / dims.dw_nt[l]) << 4 | (tt % dims.dw_nt[l]) << 12 : ~0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.f;
  }

  const int num_tiles = (n + kTcRows - 1) / kTcRows;
  auto stage = [&](int tile, int buf) {  // this warp's 16 rows of x and g
    const int wtile = tile * kTcWarps + warp;
    umhs::stage_rows(x, n, wtile, 16, xbuf + buf * dims.x_floats, d0, dims.xs, dims.x_row_magic,
                     lane);
    umhs::stage_rows(g, n, wtile, 16, gbuf + buf * dims.g_floats, dl, dims.gs, dims.g_row_magic,
                     lane);
  };
  int tile = blockIdx.x, cur = 0;
  if (tile < num_tiles) stage(tile, 0);
  umhs::cp_async_commit();
  StoreInputs inputs{dims, area, row, tig};

  for (; tile < num_tiles; tile += gridDim.x) {
    if (tile + gridDim.x < num_tiles) stage(tile + gridDim.x, cur ^ 1);
    umhs::cp_async_commit();
    umhs::cp_async_wait<1>();  // this tile's rows have landed
    __syncwarp();
    float* xs = xbuf + cur * dims.x_floats;
    const float* gs = gbuf + cur * dims.g_floats;

    // The recompute: K1's chain up to the last layer's input, every a_l
    // stored into the tile area.
    {
      uint32_t a[1][kKT][4];
      umhs::x_fragments<kKT, 1>(a, xs, dims.xs, d0, c.kt[0], lane);
      inputs.hidden(0, a);
      umhs::chain_forward<kKT, 1>(a, c, wt, bias, L - 1, lane, inputs);
    }

    // The last layer's output gradient is g: db in f32, then bf16.
    uint32_t dA[kKT][4];  // dh of the layer at hand, bf16 A fragments
    {
      const int l = L - 1, s = 16 * dims.nk[l] + 8;
#pragma unroll
      for (int kt = 0; kt < kKT; ++kt) {
        if (kt < dims.nk[l]) {
          const int col = 16 * kt + 2 * tig;
          const float2 p0 = umhs::x_pair(gs, dims.gs, dl, gid, col);
          const float2 p1 = umhs::x_pair(gs, dims.gs, dl, gid + 8, col);
          const float2 p2 = umhs::x_pair(gs, dims.gs, dl, gid, col + 8);
          const float2 p3 = umhs::x_pair(gs, dims.gs, dl, gid + 8, col + 8);
          col_sums(dbw + dims.db_off[l] + col, p0.x + p1.x, p0.y + p1.y, lane);
          col_sums(dbw + dims.db_off[l] + col + 8, p2.x + p3.x, p2.y + p3.y, lane);
          dA[kt][0] = umhs::pack_bf16x2(p0.x, p0.y);
          dA[kt][1] = umhs::pack_bf16x2(p1.x, p1.y);
          dA[kt][2] = umhs::pack_bf16x2(p2.x, p2.y);
          dA[kt][3] = umhs::pack_bf16x2(p3.x, p3.y);
          store_frag(area + dims.dh_off[l], s, row, tig, kt, dA[kt]);
        }
      }
    }

    // dh . W_l^T, layer by layer down: the f32 product is the output gradient
    // of layer l - 1, gated by a_l > 0, summed into db in f32, rounded to bf16
    // (the next A fragments, and dh_{l-1} in the tile area); below layer 0 it
    // is dx, f32, staged in this warp's x buffer (x is no longer needed).
    for (int l = L - 1; l >= (dx != nullptr ? 0 : 1); --l) {
      const int kts = dims.nk[l], pairs = c.kt[l];
      const int s = 16 * kts + 8;
      const __nv_bfloat16* w = wb + dims.wb_off[l];
      const int ps = 16 * pairs + 8;  // row stride of a_l and of dh_{l-1}
      __nv_bfloat16* post = area + dims.act_off[l];
      uint32_t dn[kKT][4];
#pragma unroll
      for (int j = 0; j < kKT; ++j) {  // n-tiles 2j and 2j + 1 of layer l's input
        if (j < pairs) {
          const __nv_bfloat16* wrow =
              w + (16 * j + 8 * (lane >> 4) + (lane & 7)) * s + 8 * ((lane >> 3) & 1);
          float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kt = 0; kt < kKT; ++kt) {
            if (kt < kts) {
              uint32_t bf[4];
              umhs::ldmatrix_x4(bf, wrow + 16 * kt);
              umhs::mma_bf16_16816(c0, dA[kt], bf[0], bf[1]);
              umhs::mma_bf16_16816(c1, dA[kt], bf[2], bf[3]);
            }
          }
          const int col = 16 * j + 2 * tig;
          if (l > 0) {
            const uint32_t* m = frag_at(post, ps, row, tig, j);
            const uint32_t m0 = m[0], m1 = m[4 * ps], m2 = m[4], m3 = m[4 * ps + 4];
            c0[0] = gate(m0, 0, c0[0]);
            c0[1] = gate(m0, 1, c0[1]);
            c0[2] = gate(m1, 0, c0[2]);
            c0[3] = gate(m1, 1, c0[3]);
            c1[0] = gate(m2, 0, c1[0]);
            c1[1] = gate(m2, 1, c1[1]);
            c1[2] = gate(m3, 0, c1[2]);
            c1[3] = gate(m3, 1, c1[3]);
            float* db = dbw + dims.db_off[l - 1] + col;
            col_sums(db, c0[0] + c0[2], c0[1] + c0[3], lane);
            col_sums(db + 8, c1[0] + c1[2], c1[1] + c1[3], lane);
            dn[j][0] = umhs::pack_bf16x2(c0[0], c0[1]);
            dn[j][1] = umhs::pack_bf16x2(c0[2], c0[3]);
            dn[j][2] = umhs::pack_bf16x2(c1[0], c1[1]);
            dn[j][3] = umhs::pack_bf16x2(c1[2], c1[3]);
            store_frag(area + dims.dh_off[l - 1], ps, row, tig, j, dn[j]);
          } else {
            float* r0 = xs + gid * dims.xs;
            float* r1 = r0 + 8 * dims.xs;
            const float v[2][4] = {{c0[0], c0[1], c0[2], c0[3]}, {c1[0], c1[1], c1[2], c1[3]}};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int cc = col + 8 * h;
              if (cc < d0) {
                r0[cc] = v[h][0];
                r1[cc] = v[h][2];
              }
              if (cc + 1 < d0) {
                r0[cc + 1] = v[h][1];
                r1[cc + 1] = v[h][3];
              }
            }
          }
        }
      }
      if (l > 0) {
#pragma unroll
        for (int j = 0; j < kKT; ++j)
          if (j < pairs)
#pragma unroll
            for (int q = 0; q < 4; ++q) dA[j][q] = dn[j][q];
      }
    }

    if (dx != nullptr) {  // the dx tile is row-major and contiguous in dx
      __syncwarp();
      const int64_t row0 = (static_cast<int64_t>(tile) * kTcWarps + warp) * 16;
      const int rows = n - row0 < 16 ? static_cast<int>(n - row0) : 16;
      float* dxt = dx + row0 * d0;
      if (d0 % 4 == 0) {
        const int q4 = d0 / 4;
        for (int v = lane; v < rows * q4; v += 32) {
          const int r = umhs::fast_div(v, dims.dx_magic);
          *reinterpret_cast<float4*>(dxt + 4 * v) =
              *reinterpret_cast<const float4*>(xs + r * dims.xs + 4 * (v - r * q4));
        }
      } else {
        for (int e = lane; e < rows * d0; e += 32) {
          const int r = umhs::fast_div(e, dims.dx_magic);
          dxt[e] = xs[r * dims.xs + e - r * d0];
        }
      }
    }
    __syncthreads();  // every warp's a_l and dh_l are in the tile area

    // dW_l += a_l^T . dh_l over the tile's rows, for the tiles this warp
    // owns: both operands sum over rows, so both come in transposed.
#pragma unroll
    for (int t = 0; t < kOwn; ++t) {
      if (own[t] != ~0u) {
        const int l = own[t] & 15, mt = (own[t] >> 4) & 255, nt = own[t] >> 12;
        const int as = 16 * c.kt[l] + 8, bs = 16 * dims.nk[l] + 8;
        const __nv_bfloat16* arow = area + dims.act_off[l] +
            ((lane & 7) + 8 * (lane >> 4)) * as + 16 * mt + 8 * ((lane >> 3) & 1);
        const __nv_bfloat16* brow = area + dims.dh_off[l] +
            ((lane & 7) + 8 * ((lane >> 3) & 1)) * bs + 8 * nt;
#pragma unroll
        for (int k0 = 0; k0 < kTcRows; k0 += 16) {
          uint32_t af[4], bf[2];
          umhs::ldmatrix_x4_trans(af, arow + k0 * as);
          umhs::ldmatrix_x2_trans(bf, brow + k0 * bs);
          umhs::mma_bf16_16816(acc[t], af, bf[0], bf[1]);
        }
      }
    }
    __syncthreads();  // the tile area is free for the next tile
    cur ^= 1;
  }
  umhs::cp_async_wait<0>();

  // This block's sums into its row of partials: dW from the owners'
  // registers, db from the warps' column sums added in warp order.
  float* part = partials + static_cast<size_t>(blockIdx.x) * dims.param_floats;
#pragma unroll
  for (int t = 0; t < kOwn; ++t) {
    if (own[t] != ~0u) {
      const int l = own[t] & 15, mt = (own[t] >> 4) & 255, nt = own[t] >> 12;
      const int din = c.d[l], dout = c.d[l + 1];
      float* pw = part + dims.goff[l];
      const int i0 = 16 * mt + gid, j0 = 8 * nt + 2 * tig;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + 8 * (q >> 1), j = j0 + (q & 1);
        if (i < din && j < dout) pw[i * dout + j] = acc[t][q];
      }
    }
  }
  for (int l = 0; l < L; ++l) {
    const int din = c.d[l], dout = c.d[l + 1];
    for (int j = threadIdx.x; j < dout; j += kTcThreads) {
      float s = 0.f;
      for (int w = 0; w < kTcWarps; ++w) s += dbs[w * dims.db_floats + dims.db_off[l] + j];
      part[dims.goff[l] + din * dout + j] = s;
    }
  }
}

// Fills `td` and the shared-memory bytes of the tensor-core kernel, with
// its template arguments: the k-tiles its activations span (4 or 8) and
// the dW tiles a warp may own (8 or 16; 8 at 8 k-tiles); false when the
// chain is not one it takes: a padded width above 128, more dW tiles than
// its warps hold in registers, or too much shared memory.
bool tc_bwd_dims(const int* d, int L, TcBwdDims& td, size_t& smem, int& kts, int& own) {
  using umhs::round_up;
  td = TcBwdDims{};
  if (!umhs::tc_chain(d, L, td.c)) return false;
  // the recompute stops at the last layer's input
  td.c.w_bytes = round_up(2 * td.c.w_off[L - 1], 16);
  td.c.b_floats = round_up(td.c.b_off[L - 1], 4);
  int wb = 0, act = 0, dh = 0, db = 0, goff = 0, tiles = 0, widest = 0;
  for (int l = 0; l < L; ++l) {
    const int kt = td.c.kt[l], nk = round_up(d[l + 1], 16) / 16;
    td.nk[l] = nk;
    td.wb_off[l] = wb;
    wb += 16 * kt * (16 * nk + 8);
    td.act_off[l] = act;
    act += kTcRows * (16 * kt + 8);
    td.dh_off[l] = dh;
    dh += kTcRows * (16 * nk + 8);
    td.goff[l] = goff;
    goff += d[l] * d[l + 1] + d[l + 1];
    td.db_off[l] = db;
    db += 16 * nk;
    td.dw_nt[l] = round_up(d[l + 1], 8) / 8;
    tiles += kt * td.dw_nt[l];
    widest = std::max({widest, kt, nk});
  }
  for (int l = 0; l < L; ++l) td.dh_off[l] += act;  // the dh_l follow the a_l
  td.wb_bytes = td.c.w_bytes + 2 * wb;
  td.tile_bytes = 2 * (act + dh);
  td.db_floats = round_up(db, 4);
  td.param_floats = goff;
  const int d0 = d[0], dl = d[L];
  // rows of a width that is a multiple of 4 land at a stride of 8 (mod 32)
  // floats, as in K1, so fragment loads of a half-warp fall on distinct banks
  td.xs = d0 % 4 == 0 ? round_up(d0, 32) + 8 : d0;
  td.x_floats = round_up(16 * td.xs, 4);
  td.gs = dl % 4 == 0 ? round_up(dl, 32) + 8 : dl;
  td.g_floats = round_up(16 * td.gs, 4);
  td.x_row_magic = umhs::magic_for(std::max(d0 / 4, 1));
  td.g_row_magic = umhs::magic_for(std::max(dl / 4, 1));
  td.dx_magic = umhs::magic_for(d0 % 4 == 0 ? d0 / 4 : d0);
  kts = widest <= 4 ? 4 : 8;
  const int per_warp = (tiles + kTcWarps - 1) / kTcWarps;
  own = per_warp <= 8 ? 8 : 16;
  if (per_warp > (kts == 4 ? 16 : 8)) return false;
  smem = static_cast<size_t>(td.wb_bytes) + sizeof(float) * td.c.b_floats + td.tile_bytes +
         sizeof(float) * kTcWarps * (2 * td.x_floats + 2 * td.g_floats + td.db_floats);
  return smem <= static_cast<size_t>(kSmemLimit);
}

template <int kKT, int kOwn>
cudaError_t launch_tc(const float* x, const float* g, const float* params, float* dx,
                      float* partials, float* dparams, int n, const TcBwdDims& td, size_t smem,
                      int max_blocks, cudaStream_t stream) {
  auto kernel = mlp_fused_bwd_tc_kernel<kKT, kOwn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTcThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kTcRows - 1) / kTcRows;
  const int grid = std::max(1, std::min({tiles, std::max(per_sm, 1) * umhs::num_sms(),
                                         max_blocks}));
  kernel<<<grid, kTcThreads, smem, stream>>>(x, g, params, dx, partials, n, td);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = td.param_floats;
  reduce_partials_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partials, dparams, grid, count);
  return cudaGetLastError();
}

// -------------------------------------------- tensor cores, wider than 128

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kWideRows = 16 * kWideWarps;  // rows of a block's tile: 16 per warp
constexpr int kWideOwn = 9;                 // dW tiles a warp owns

// A two-layer chain d0 -> d1 -> d2, its hidden width cut into slices of 16 hk
// columns, one slice per blockIdx.y.
struct WideBwdDims {
  int d0, d1, d2;
  int kt0, nk2, nt2;     // 16-wide k-tiles of x and of g; 8-wide n-tiles of g
  int hk, slices;        // 16-wide hidden k-tiles of a slice (the last may have fewer)
  // byte offsets in shared memory, each a multiple of 16:
  int w0t, w1s, w0s, b0;         // W0[:, c]^T, W1[c, :], W0[:, c] (bf16), b0[c] (f32)
  int act0, act1, gb, dh1, dbs;  // the tile's x, a1[:, c], g, dh1[:, c] (bf16); column sums
  int stage;                     // each warp's next 16 rows of x and g (f32), or -1: none
  int db_floats;                 // floats of one warp's column sums: db0[c], then db1
  int param_floats;              // unpadded weights + biases (global layout)
  int smem;
};

// Rows of g (width d, row-major) from row row0 on into a warp's 16 rows of
// gb (bf16, row stride gs, zero past row n and from column d to 16 nk);
// with db, also each column's f32 sum over the 16 rows into db. Each lane
// owns column pairs 2 cp, 2 cp + 1. g is device memory, or the warp's
// staged copy (row0 0, n 16).
__device__ __forceinline__ void stage_g(const float* __restrict__ g, int n, int64_t row0, int d,
                                        int nk, __nv_bfloat16* gb, int gs, float* db, int lane) {
  for (int cp = lane; cp < 8 * nk; cp += 32) {
    const int col = 2 * cp;
    float2 v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int64_t row = row0 + r;
      const float* src = g + row * d + col;
      if (row >= n || col >= d)
        v[r] = make_float2(0.f, 0.f);
      else if ((d & 1) == 0)
        v[r] = *reinterpret_cast<const float2*>(src);
      else
        v[r] = make_float2(src[0], col + 1 < d ? src[1] : 0.f);
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      s0 += v[r].x;
      s1 += v[r].y;
      *reinterpret_cast<uint32_t*>(gb + r * gs + col) = umhs::pack_bf16x2(v[r].x, v[r].y);
    }
    if (db != nullptr) {
      db[col] += s0;
      db[col + 1] += s1;
    }
  }
}

// Block (r, c) walks tiles r, r + gridDim.x, ... of 128 rows for slice c of
// the hidden width: the recompute of a1[:, c] (K1's pairs_product on the
// same k-tiles, so K1's bits and ReLU decisions), dh1[:, c] = bf16(g) .
// W1[c, :]^T gated by a1 > 0, and (with dx) this slice's share of dx,
// dh1[:, c] . W0[:, c]^T, into its own partial slice. After a block
// barrier, the dW tiles of the slice, dW0[:, c] = x^T . dh1[:, c] and
// dW1[c, :] = a1[:, c]^T . bf16(g), sum over the tile's rows into the
// registers of the warp that owns them (tiles 9 w .. 9 w + 8 for warp w).
__global__ void __launch_bounds__(kWideThreads, 1)
mlp_fused_bwd_wide_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ params, float* __restrict__ dxp,
                          float* __restrict__ partials, int n, WideBwdDims dims) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d0 = dims.d0, d1 = dims.d1, d2 = dims.d2, kt0 = dims.kt0, nk2 = dims.nk2;
  const int slice = blockIdx.y, col0 = 16 * dims.hk * slice;
  const int hkc = min(dims.hk, (d1 + 15) / 16 - dims.hk * slice);  // this slice's k-tiles
  const int hw = 16 * dims.hk;  // columns of a full slice
  const int s0 = 16 * kt0 + 8, sh = hw + 8, sg = 16 * nk2 + 8;  // row strides, bf16
  auto at = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem_raw + off); };
  __nv_bfloat16 *w0t = at(dims.w0t), *w1s = at(dims.w1s), *w0s = at(dims.w0s);
  __nv_bfloat16 *act0 = at(dims.act0), *act1 = at(dims.act1), *gb = at(dims.gb);
  __nv_bfloat16* dh1 = at(dims.dh1);
  float* b0 = reinterpret_cast<float*>(smem_raw + dims.b0);
  float* dbs = reinterpret_cast<float*>(smem_raw + dims.dbs);
  const int tid = threadIdx.x;

  // This slice's weights, zero-padded, and zeroed column sums; once per block.
  for (int i = tid; i < dims.act0 / 16; i += kWideThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < kWideWarps * dims.db_floats; i += kWideThreads) dbs[i] = 0.f;
  __syncthreads();
  const int cols = min(hw, d1 - col0);  // real hidden columns of the slice
  for (int e = tid; e < d0 * cols; e += kWideThreads) {
    const int i = e / cols, h = e - i * cols;
    const __nv_bfloat16 v = __float2bfloat16_rn(params[i * d1 + col0 + h]);
    w0t[h * s0 + i] = v;
    w0s[i * sh + h] = v;
  }
  for (int e = tid; e < cols * d2; e += kWideThreads) {
    const int h = e / d2, o = e - h * d2;
    w1s[h * sg + o] = __float2bfloat16_rn(params[d0 * d1 + d1 + (col0 + h) * d2 + o]);
  }
  for (int h = tid; h < hw; h += kWideThreads) b0[h] = h < cols ? params[d0 * d1 + col0 + h] : 0.f;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rw = 16 * warp;  // this warp's first row in the tile area
  float* dbw = dbs + warp * dims.db_floats;
  float* dxc = dxp == nullptr ? nullptr : dxp + static_cast<size_t>(slice) * n * d0;
  const int t0 = kt0 * 2 * hkc, tiles_owned = t0 + hkc * dims.nt2;  // dW0, then dW1 tiles
  float acc[kWideOwn][4];
#pragma unroll
  for (int u = 0; u < kWideOwn; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[u][q] = 0.f;

  // The next tile's rows come in by cp.async while this one computes, where
  // the shared memory holds a staging area; else straight from device memory.
  const bool staged = dims.stage >= 0;
  float* xst = staged ? reinterpret_cast<float*>(smem_raw + dims.stage) + warp * 16 * (d0 + d2)
                      : nullptr;
  float* gst = staged ? xst + 16 * d0 : nullptr;
  auto prefetch = [&](int tile) {
    umhs::stage_rows(x, n, tile * kWideWarps + warp, 16, xst, d0, d0, 0, lane);
    umhs::stage_rows(g, n, tile * kWideWarps + warp, 16, gst, d2, d2, 0, lane);
  };
  const int num_tiles = (n + kWideRows - 1) / kWideRows;
  if (staged && blockIdx.x < num_tiles) prefetch(blockIdx.x);
  umhs::cp_async_commit();
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t row0 = static_cast<int64_t>(tile) * kWideRows + rw;
    umhs::cp_async_wait<0>();  // this tile's rows have landed
    __syncwarp();
    umhs::stage_x_bf16(staged ? xst : x, staged ? 16 : n, staged ? 0 : row0, 16, d0, 16 * kt0,
                       act0 + rw * s0, s0, lane);
    stage_g(staged ? gst : g, staged ? 16 : n, staged ? 0 : row0, d2, nk2, gb + rw * sg, sg,
            slice == 0 ? dbw + hw : nullptr, lane);
    __syncwarp();  // the staging area is free
    if (staged && tile + gridDim.x < num_tiles) prefetch(tile + gridDim.x);
    umhs::cp_async_commit();

    // the recompute: a1[:, c] = relu(x . W0[:, c] + b0[c]), bf16
    float pr[4][2][4];
    umhs::pairs_product<4>(pr, act0 + rw * s0, s0, w0t, s0, hkc, kt0, lane);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (p >= hkc) continue;
        const int col = 16 * p + 8 * h + 2 * tig;
        const float2 bv = *reinterpret_cast<const float2*>(b0 + col);
        const float* v = pr[p][h];
        *reinterpret_cast<uint32_t*>(act1 + (rw + gid) * sh + col) =
            umhs::pack_bf16x2(fmaxf(v[0] + bv.x, 0.f), fmaxf(v[1] + bv.y, 0.f));
        *reinterpret_cast<uint32_t*>(act1 + (rw + gid + 8) * sh + col) =
            umhs::pack_bf16x2(fmaxf(v[2] + bv.x, 0.f), fmaxf(v[3] + bv.y, 0.f));
      }
    __syncwarp();

    // dh1[:, c] = bf16(g) . W1[c, :]^T, gated by a1 > 0, summed into db0 in
    // f32, then rounded to bf16
    umhs::pairs_product<4>(pr, gb + rw * sg, sg, w1s, sg, hkc, nk2, lane);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (p >= hkc) continue;
        const int col = 16 * p + 8 * h + 2 * tig;
        float* v = pr[p][h];
        const uint32_t m0 = *reinterpret_cast<const uint32_t*>(act1 + (rw + gid) * sh + col);
        const uint32_t m1 = *reinterpret_cast<const uint32_t*>(act1 + (rw + gid + 8) * sh + col);
        v[0] = gate(m0, 0, v[0]);
        v[1] = gate(m0, 1, v[1]);
        v[2] = gate(m1, 0, v[2]);
        v[3] = gate(m1, 1, v[3]);
        col_sums(dbw + col, v[0] + v[2], v[1] + v[3], lane);
        *reinterpret_cast<uint32_t*>(dh1 + (rw + gid) * sh + col) = umhs::pack_bf16x2(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(dh1 + (rw + gid + 8) * sh + col) =
            umhs::pack_bf16x2(v[2], v[3]);
      }

    if (dxc != nullptr) {  // this slice's dx: dh1[:, c] . W0[:, c]^T, f32
      __syncwarp();
      for (int q0 = 0; q0 < kt0; q0 += 4) {
        umhs::pairs_product<4>(pr, dh1 + rw * sh, sh, w0s + 16 * q0 * sh, sh, min(4, kt0 - q0),
                               hkc, lane);
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int col = 16 * (q0 + p) + 8 * h + 2 * tig;
            if (q0 + p >= kt0 || col >= d0) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int64_t row = row0 + gid + 8 * half;
              if (row >= n) continue;
              float* out = dxc + row * d0 + col;
              out[0] = pr[p][h][2 * half];
              if (col + 1 < d0) out[1] = pr[p][h][2 * half + 1];
            }
          }
      }
    }
    __syncthreads();  // every warp's rows are in the tile area

    // dW += a^T . dh over the tile's rows for the tiles this warp owns: both
    // operands sum over rows, so both come in transposed. A warp's tiles are
    // neighbours in (dW0 then dW1, m-tile, n-tile) order, so most share their
    // A fragment, which is read once per 16 rows for all of them.
    uint32_t af[kWideRows / 16][4];
    int akey = -1;
#pragma unroll
    for (int u = 0; u < kWideOwn; ++u) {
      const int t = kWideOwn * warp + u;
      if (t < tiles_owned) {
        const bool first = t < t0;  // dW0[:, c]: 16-row m-tiles of x, 8-wide n-tiles of dh1
        const int tt = first ? t : t - t0, nts = first ? 2 * hkc : dims.nt2;
        const int mt = tt / nts, nt = tt - mt * nts;
        const int as = first ? s0 : sh, bs = first ? sh : sg;
        if ((first ? mt : 256 + mt) != akey) {
          akey = first ? mt : 256 + mt;
          const __nv_bfloat16* arow = (first ? act0 : act1) +
              ((lane & 7) + 8 * (lane >> 4)) * as + 16 * mt + 8 * ((lane >> 3) & 1);
#pragma unroll
          for (int k = 0; k < kWideRows / 16; ++k)
            umhs::ldmatrix_x4_trans(af[k], arow + 16 * k * as);
        }
        const __nv_bfloat16* brow = (first ? dh1 : gb) +
            ((lane & 7) + 8 * ((lane >> 3) & 1)) * bs + 8 * nt;
#pragma unroll
        for (int k = 0; k < kWideRows / 16; ++k) {
          uint32_t bf[2];
          umhs::ldmatrix_x2_trans(bf, brow + 16 * k * bs);
          umhs::mma_bf16_16816(acc[u], af[k], bf[0], bf[1]);
        }
      }
    }
    __syncthreads();  // the tile area is free for the next tile
  }
  umhs::cp_async_wait<0>();

  // This block's sums into its row of partials: the slice's part of dW0,
  // b0 and dW1 (and b1 from slice 0); every slice of row r writes its own
  // entries, so the row is whole.
  float* part = partials + static_cast<size_t>(blockIdx.x) * dims.param_floats;
  const int goff1 = d0 * d1 + d1;
#pragma unroll
  for (int u = 0; u < kWideOwn; ++u) {
    const int t = kWideOwn * warp + u;
    if (t < tiles_owned) {
      const bool first = t < t0;
      const int tt = first ? t : t - t0, nts = first ? 2 * hkc : dims.nt2;
      const int mt = tt / nts, nt = tt - mt * nts;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 16 * mt + gid + 8 * (q >> 1), j = 8 * nt + 2 * tig + (q & 1);
        if (first && i < d0 && j < cols) part[i * d1 + col0 + j] = acc[u][q];
        if (!first && i < cols && j < d2) part[goff1 + (col0 + i) * d2 + j] = acc[u][q];
      }
    }
  }
  for (int j = tid; j < cols; j += kWideThreads) {
    float s = 0.f;
    for (int w = 0; w < kWideWarps; ++w) s += dbs[w * dims.db_floats + j];
    part[d0 * d1 + col0 + j] = s;
  }
  if (slice == 0) {
    for (int j = tid; j < d2; j += kWideThreads) {
      float s = 0.f;
      for (int w = 0; w < kWideWarps; ++w) s += dbs[w * dims.db_floats + hw + j];
      part[goff1 + d1 * d2 + j] = s;
    }
  }
}

// Fills `wd` for the wide kernel; false when the chain is not one it takes:
// other than two layers, a padded width above 256, or too much shared
// memory. A slice is 64 hidden columns, or 32 or 16 where the slice's dW
// tiles would exceed what its warps hold in registers.
bool wide_bwd_dims(const int* d, int L, WideBwdDims& wd) {
  using umhs::round_up;
  wd = WideBwdDims{};
  if (L != 2) return false;
  const int d0p = round_up(d[0], 16), h1p = round_up(d[1], 16), d2p = round_up(d[2], 16);
  if (std::max({d0p, h1p, d2p}) > umhs::kWideMaxWidth) return false;
  wd.d0 = d[0];
  wd.d1 = d[1];
  wd.d2 = d[2];
  wd.kt0 = d0p / 16;
  wd.nk2 = d2p / 16;
  wd.nt2 = round_up(d[2], 8) / 8;
  int hk = 4;
  while (hk > 1 && hk * (2 * wd.kt0 + wd.nt2) > kWideWarps * kWideOwn) hk /= 2;
  if (hk * (2 * wd.kt0 + wd.nt2) > kWideWarps * kWideOwn) return false;
  wd.hk = std::min(hk, h1p / 16);
  wd.slices = (h1p / 16 + wd.hk - 1) / wd.hk;
  const int hw = 16 * wd.hk, s0 = d0p + 8, sh = hw + 8, sg = d2p + 8;
  int off = 0;
  auto take = [&](int bytes) { const int at = off; off += round_up(bytes, 16); return at; };
  wd.w0t = take(2 * hw * s0);
  wd.w1s = take(2 * hw * sg);
  wd.w0s = take(2 * d0p * sh);
  wd.b0 = take(4 * hw);
  wd.act0 = take(2 * kWideRows * s0);  // the weights, zeroed as one, end here
  wd.act1 = take(2 * kWideRows * sh);
  wd.gb = take(2 * kWideRows * sg);
  wd.dh1 = take(2 * kWideRows * sh);
  wd.db_floats = round_up(hw + d2p, 4);
  wd.dbs = take(4 * kWideWarps * wd.db_floats);
  const int staged = off + 4 * kWideWarps * 16 * (d[0] + d[2]);
  wd.stage = staged <= kSmemLimit ? off : -1;  // the DINO chain's: 72 KB
  wd.smem = std::max(off, wd.stage >= 0 ? staged : 0);
  wd.param_floats = d[0] * d[1] + d[1] + d[1] * d[2] + d[2];
  return wd.smem <= kSmemLimit;
}

cudaError_t launch_wide(const float* x, const float* g, const float* params, float* dx,
                        float* dx_partials, float* partials, float* dparams, int n,
                        const WideBwdDims& wd, int max_blocks, cudaStream_t stream) {
  auto kernel = mlp_fused_bwd_wide_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wd.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWideThreads, wd.smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kWideRows - 1) / kWideRows;
  const int rows = std::max(1, std::min({tiles, std::max(per_sm, 1) * umhs::num_sms() / wd.slices,
                                         max_blocks}));
  // dx: straight into dx with one slice, else each slice's share into its
  // partial slice, summed in slice order below
  float* dxp = dx == nullptr ? nullptr : (wd.slices == 1 ? dx : dx_partials);
  kernel<<<dim3(rows, wd.slices), kWideThreads, wd.smem, stream>>>(x, g, params, dxp, partials,
                                                                  n, wd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = wd.param_floats;
  reduce_partials_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partials, dparams, rows, count);
  err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr || wd.slices == 1 || n == 0) return err;
  const int dx_count = n * wd.d0;
  reduce_partials_kernel<<<(dx_count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      dx_partials, dx, wd.slices, dx_count);
  return cudaGetLastError();
}

// The bf16 route of the chain d[0..L]: 100 kKT + kOwn for
// mlp_fused_bwd_tc_kernel<kKT, kOwn>, 1 for mlp_fused_bwd_wide_kernel, 0 for
// the FMA kernel; fills the dims of the kernel it names.
int bf16_route(const int* d, int L, TcBwdDims& td, size_t& smem, WideBwdDims& wd) {
  int kts = 0, own = 0;
  if (tc_bwd_dims(d, L, td, smem, kts, own)) return 100 * kts + own;
  if (wide_bwd_dims(d, L, wd)) return 1;
  return 0;
}

// Where a chain goes that no kernel above takes (K1's rule): 3, the fused
// route (mlp_chain_fused.cuh), for a bf16 chain it takes; else 2, the
// general route (mlp_general.cuh).
int past_the_fused_kernels(const int* d, int L, bool bf16) {
  return bf16 && umhs::chain::chain_fits(d, L) ? 3 : 2;
}

// The route of the chain d[0..L] in this mode: the bf16 codes above, 0 for
// the FMA kernel, 2 for the general route, 3 for the fused route (the rule
// K1's launcher applies too); -1 for a chain it refuses (a width below 1).
int route_of(const int* d, int L, bool bf16, TcBwdDims& td, size_t& smem, WideBwdDims& wd) {
  if (L < 1) return -1;
  for (int l = 0; l <= L; ++l)
    if (d[l] < 1) return -1;
  if (!umhs::fused_shape(d, L)) return past_the_fused_kernels(d, L, bf16);
  if (bf16) {
    const int r = bf16_route(d, L, td, smem, wd);
    if (r != 0) return r;
  }
  return umhs::fma_takes(d, L) ? 0 : past_the_fused_kernels(d, L, bf16);
}

// The index of a route code among the wrapper's names (MLP_BWD_ROUTES).
int route_index(int code, bool bf16) {
  switch (code) {
    case 0: return bf16 ? 1 : 0;
    case 808: return 2;
    case 408: return 3;
    case 416: return 4;
    case 1: return 5;
    case 3: return 8;
    default: return bf16 ? 7 : 6;
  }
}

}  // namespace

// x: (n, dims[0]) f32; g: (n, dims[num_layers]) f32, the gradient of the
// chain's output; params: [W0, b0, W1, b1, ...] f32 as for K1. Writes dx
// (n, dims[0]) unless dx is null, and dparams in the params layout.
// partials: umhs_mlp_fused_bwd_scratch_bytes(...) bytes of device scratch,
// 256-byte aligned (the fused kernels' max_blocks x len(params) floats of
// partial sums, or the general route's buffers); max_blocks >= 1. Writes
// the route it took (its index among the wrapper's route names) to *route.
// Returns a cudaError_t.
extern "C" int umhs_mlp_fused_bwd(const float* x, const float* g, const float* params,
                                  float* dx, float* dx_partials, float* partials,
                                  int64_t partials_bytes, float* dparams, const int* dims_host,
                                  int num_layers, int n, int bf16, int max_blocks, void* stream,
                                  int32_t* route_out) {
  TcBwdDims td;
  WideBwdDims wd;
  size_t smem = 0;
  const int route = route_of(dims_host, num_layers, bf16 != 0, td, smem, wd);
  if (route < 0 || n < 0 || max_blocks < 1) return cudaErrorInvalidValue;
  *route_out = route_index(route, bf16 != 0);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 3) {
    const size_t need = umhs::chain::bwd_scratch_bytes(dims_host, num_layers, n);
    if (partials == nullptr || reinterpret_cast<uintptr_t>(partials) % 256 != 0 ||
        partials_bytes < static_cast<int64_t>(need))
      return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dx) % 16 != 0)
      return cudaErrorMisalignedAddress;
    return umhs::chain::backward(x, g, params, dx, dparams, n, dims_host, num_layers, partials,
                                 s);
  }
  if (route == 2) {
    const size_t need = umhs::general::bwd_scratch_bytes(dims_host, num_layers, bf16 != 0, n);
    if (partials == nullptr || reinterpret_cast<uintptr_t>(partials) % 256 != 0 ||
        partials_bytes < static_cast<int64_t>(need))
      return cudaErrorInvalidValue;
    if (n == 0) {  // no rows: every gradient is zero
      int64_t count = 0;
      for (int l = 0; l < num_layers; ++l)
        count += int64_t{dims_host[l]} * dims_host[l + 1] + dims_host[l + 1];
      return cudaMemsetAsync(dparams, 0, sizeof(float) * count, s);
    }
    return bf16 ? umhs::general::backward<__nv_bfloat16>(x, g, params, dx, dparams, n, dims_host,
                                                         num_layers, partials, s)
                : umhs::general::backward<float>(x, g, params, dx, dparams, n, dims_host,
                                                 num_layers, partials, s);
  }
  if (bf16) {
    if (route != 0 && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                       reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
                       reinterpret_cast<uintptr_t>(dx) % 16 != 0))
      return cudaErrorMisalignedAddress;
    switch (route) {
      case 808: return launch_tc<8, 8>(x, g, params, dx, partials, dparams, n, td, smem,
                                       max_blocks, s);
      case 408: return launch_tc<4, 8>(x, g, params, dx, partials, dparams, n, td, smem,
                                       max_blocks, s);
      case 416: return launch_tc<4, 16>(x, g, params, dx, partials, dparams, n, td, smem,
                                        max_blocks, s);
      case 1:
        if (dx != nullptr && wd.slices > 1 &&
            (dx_partials == nullptr || static_cast<int64_t>(n) * wd.d0 >= (int64_t{1} << 31)))
          return cudaErrorInvalidValue;
        return launch_wide(x, g, params, dx, dx_partials, partials, dparams, n, wd, max_blocks,
                           s);
      default: break;
    }
  }
  Dims dims{};
  dims.num_layers = num_layers;
  int max_width4 = 0, w_floats = 0, param_floats = 0, act_rows = 0;
  for (int l = 0; l <= num_layers; ++l) {
    dims.d[l] = dims_host[l];
    max_width4 = std::max(max_width4, round4(dims_host[l]));
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
  size_t fma_smem = 0;
  const int tr = umhs::fma_bwd_tile(dims_host, num_layers, &fma_smem);
  dims.tile_rows = tr;
  dims.stride = tr + 4;
  for (int l = 0; l < num_layers; ++l) dims.aoff[l] *= dims.stride;
  dims.act_floats = act_rows * dims.stride;
  return bf16 ? launch<true>(x, g, params, dx, partials, dparams, n, dims, fma_smem, max_blocks, s)
              : launch<false>(x, g, params, dx, partials, dparams, n, dims, fma_smem, max_blocks,
                              s);
}

// The kernel umhs_mlp_fused_bwd runs for the chain dims[0..num_layers] in
// this mode: 100 kKT + kOwn for mlp_fused_bwd_tc_kernel<kKT, kOwn>, 1 for
// mlp_fused_bwd_wide_kernel, 0 for the FMA kernel, 2 for the general route,
// 3 for the fused route; -1 for a chain it refuses.
extern "C" int umhs_mlp_fused_bwd_route(const int* dims_host, int num_layers, int bf16) {
  TcBwdDims td;
  WideBwdDims wd;
  size_t smem = 0;
  return route_of(dims_host, num_layers, bf16 != 0, td, smem, wd);
}

// The number of (n, dims[0]) f32 slices of dx_partials umhs_mlp_fused_bwd
// needs for this chain and mode when dx is wanted: the wide kernel's slices
// of the hidden width when there are two or more, else 0 (the general route
// writes dx directly).
extern "C" int umhs_mlp_fused_bwd_dx_slices(const int* dims_host, int num_layers, int bf16) {
  if (umhs_mlp_fused_bwd_route(dims_host, num_layers, bf16) != 1) return 0;
  WideBwdDims wd;
  wide_bwd_dims(dims_host, num_layers, wd);
  return wd.slices > 1 ? wd.slices : 0;
}

// Bytes of the scratch (`partials`) umhs_mlp_fused_bwd needs for n rows of
// the chain in this mode with max_blocks: the general and fused routes'
// buffers, else max_blocks rows of partial sums of every parameter.
extern "C" int64_t umhs_mlp_fused_bwd_scratch_bytes(const int* dims_host, int num_layers,
                                                    int bf16, int64_t n, int max_blocks) {
  const int route = umhs_mlp_fused_bwd_route(dims_host, num_layers, bf16);
  if (route < 0) return 0;
  if (route == 3)
    return static_cast<int64_t>(
        umhs::chain::bwd_scratch_bytes(dims_host, num_layers, std::max<int64_t>(n, 1)));
  if (route == 2)
    return static_cast<int64_t>(
        umhs::general::bwd_scratch_bytes(dims_host, num_layers, bf16 != 0, std::max<int64_t>(n, 1)));
  int64_t count = 0;
  for (int l = 0; l < num_layers; ++l)
    count += int64_t{dims_host[l]} * dims_host[l + 1] + dims_host[l + 1];
  return static_cast<int64_t>(sizeof(float)) * max_blocks * count;
}
