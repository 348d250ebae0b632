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
// Two kernels, chosen by mode and shape in the C launcher below (a dispatch
// on shape: a failed launch still returns its error, and nothing falls back
// from one kernel to the other):
//
// - bf16 mode, every padded width <= 128 and at most 16 dW tiles per warp
//   (8 where a width exceeds 64; the four field chains):
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
// - f32 mode, and chains the tensor-core kernel does not take (dino_mlp's
//   256, off on the main path): mlp_fused_bwd_kernel, f32 fused
//   multiply-adds from shared memory. Each thread keeps a 4x4 block of
//   outputs in registers; activations and dh are stored transposed
//   (feature-major, rows padded by 4 floats) so the row-blocked products read
//   float4s along rows, and the dW product has each thread own rows i,
//   i + D/4, i + 2D/4, i + 3D/4 so a warp's float4 reads fall in distinct
//   banks. It is bound by its shared-memory traffic.
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mlp_chain_tc.cuh"

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
  for (int l = 0; l <= num_layers; ++l)
    if (dims_host[l] < 1 || dims_host[l] > kMaxWidth) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    TcBwdDims td;
    size_t smem = 0;
    int kts = 0, own = 0;
    if (tc_bwd_dims(dims_host, num_layers, td, smem, kts, own)) {
      if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(dx) % 16 != 0)
        return cudaErrorMisalignedAddress;
      if (kts == 8) return launch_tc<8, 8>(x, g, params, dx, partials, dparams, n, td, smem,
                                           max_blocks, s);
      return own == 8 ? launch_tc<4, 8>(x, g, params, dx, partials, dparams, n, td, smem,
                                         max_blocks, s)
                      : launch_tc<4, 16>(x, g, params, dx, partials, dparams, n, td, smem,
                                          max_blocks, s);
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
  return bf16 ? launch<true>(x, g, params, dx, partials, dparams, n, dims, smem, max_blocks, s)
              : launch<false>(x, g, params, dx, partials, dparams, n, dims, smem, max_blocks, s);
}

// The kernel umhs_mlp_fused_bwd runs for the chain dims[0..num_layers] in
// this mode: 100 kKT + kOwn for mlp_fused_bwd_tc_kernel<kKT, kOwn>, 0 for
// the FMA kernel.
extern "C" int umhs_mlp_fused_bwd_route(const int* dims_host, int num_layers, int bf16) {
  if (!bf16 || num_layers < 1 || num_layers > kMaxLayers) return 0;
  TcBwdDims td;
  size_t smem = 0;
  int kts = 0, own = 0;
  if (!tc_bwd_dims(dims_host, num_layers, td, smem, kts, own)) return 0;
  return 100 * kts + own;
}
