// The general route of K1 (mlp_fused_fwd.cu) and K2 (mlp_fused_bwd.cu): every
// chain that their fused kernels cannot launch (a width above 256, more than
// 8 layers, or weights and a tile that leave no room in a block's 232,448
// bytes of shared memory) and, in bf16, the fused route of
// mlp_chain_fused.cuh does not take either (a hidden width above 256, or
// tiles past a block's shared memory), in f32 and in bf16.
//
// One launch per product of a layer. Nothing about the chain's size lives in
// registers or in a struct passed by value, so there is no cap on depth or
// width. Between layers the activations go through global scratch in the
// compute dtype (bf16 holds exactly the rounding point; f32 is f32), each
// row padded with zeros to a multiple of 16 elements, so that every staged
// row is whole 16-byte pieces at any width (281 bands, 28 inputs). The
// weights are packed once per call the same way (W_l as [pad(d_l)][pad(d_l+1)],
// rounded to bf16 in bf16 mode; the biases f32). Rows are cut into chunks
// where the scratch would pass kScratchCap bytes.
//
// Products: bf16 mode, mlp_wgmma_kernel: 128 x 256 output tiles, two
// warpgroups of wgmma m64n256k16 from 128-byte-swizzled shared memory that
// TMA fills, a four-slice ring (wgmma_bf16.cuh), the sums staged through
// shared memory for whole-row stores; f32 mode, mlp_gemm_kernel: 64 x 64
// tiles, fused multiply-adds, a thread 4 rows x 8 columns, k ascending from
// +0 and then + b: the FMA kernel's sum order, so an f32 chain gets the FMA
// kernel's bits on either route, its operands staged by cp.async as they lie
// in device memory. An operand lies k contiguous ([i][k]) or i contiguous
// ([k][i]); both kernels take either.
//
// The rounding points are K1's and K2's (mlp_fused_fwd.cu, mlp_fused_bwd.cu):
// x and W_i rounded to bf16, f32 sums, b_i added in f32, ReLU, rounding to
// bf16, an f32 output; backward, the mask post-activation > 0, db the f32
// column sum of dh, dh rounded to bf16 for dW = a^T . dh and dh . W^T with
// f32 sums, dx f32. K2 recomputes the forward with these same products, so
// each ReLU decision is K1's. dW and db are sums over rows: each block of the
// dW product takes a fixed range of rows (blockIdx.z; whole 64-row slices in
// bf16) and writes its partial sums, each block of a dh product the column
// sums of its rows, and mlp_sum_rows_kernel adds them in block order, then
// chunk after chunk. A run repeats bit for bit, and no float atomics are
// used.
//
// What bounds it on an H100: at the widths it exists for it is a chain of
// matrix products, bound by operations (bf16 on the tensor cores at
// 989 TFLOP/s, f32 at 67), plus each activation's bytes written and read once
// between layers. In bf16 each 128 x 256 tile reads its A and B slices from
// L2 (48 KB a 64-deep slice for 2M multiply-adds); the f32 products read
// shared memory with bank conflicts.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <vector>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace umhs {

constexpr int kFusedSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kFusedMaxLayers = 8;       // the fused kernels' Dims hold 8 layers
constexpr int kFusedMaxWidth = 256;      // and widths up to 256

__host__ __device__ inline int fma_round4(int v) { return (v + 3) & ~3; }

// Rows per tile of K1's FMA kernel for the chain d[0..L] (the largest that
// leaves room for two blocks per SM, else for one), or 0 when none fits;
// *smem gets its shared-memory bytes.
inline int fma_fwd_tile(const int* d, int L, size_t* smem = nullptr) {
  size_t param_floats = 0, max_width4 = 0;
  for (int l = 0; l <= L; ++l) max_width4 = std::max<size_t>(max_width4, fma_round4(d[l]));
  for (int l = 0; l < L; ++l)
    param_floats += static_cast<size_t>(d[l]) * fma_round4(d[l + 1]) + fma_round4(d[l + 1]);
  auto smem_for = [&](int tr) { return sizeof(float) * (param_floats + 2 * max_width4 * (tr + 4)); };
  for (const size_t limit : {static_cast<size_t>(kFusedSmemLimit / 2),
                             static_cast<size_t>(kFusedSmemLimit)})
    for (int t = 128; t >= 4; t /= 2)
      if (smem_for(t) <= limit) {
        if (smem) *smem = smem_for(t);
        return t;
      }
  return 0;
}

// The same for K2's FMA kernel, which also keeps every layer's input.
inline int fma_bwd_tile(const int* d, int L, size_t* smem = nullptr) {
  size_t w_floats = 0, act_rows = 0, max_width4 = 0;
  for (int l = 0; l <= L; ++l) max_width4 = std::max<size_t>(max_width4, fma_round4(d[l]));
  for (int l = 0; l < L; ++l) {
    w_floats += static_cast<size_t>(fma_round4(d[l])) * fma_round4(d[l + 1]) + fma_round4(d[l + 1]);
    act_rows += fma_round4(d[l]);
  }
  auto smem_for = [&](int tr) {
    return sizeof(float) * (w_floats + (act_rows + 2 * max_width4) * (tr + 4));
  };
  for (const size_t limit : {static_cast<size_t>(kFusedSmemLimit / 2),
                             static_cast<size_t>(kFusedSmemLimit)})
    for (int t = 128; t >= 4; t /= 2)
      if (smem_for(t) <= limit) {
        if (smem) *smem = smem_for(t);
        return t;
      }
  return 0;
}

// Whether the chain lies within the fused kernels' limits (depth, width).
inline bool fused_shape(const int* d, int L) {
  if (L > kFusedMaxLayers) return false;
  for (int l = 0; l <= L; ++l)
    if (d[l] > kFusedMaxWidth) return false;
  return true;
}

// Whether the FMA kernels take the chain: K1's and K2's both, so that a
// chain's forward and backward run the same arithmetic (one of them alone
// sends the chain to the general route in both).
inline bool fma_takes(const int* d, int L) {
  return fused_shape(d, L) && fma_fwd_tile(d, L) > 0 && fma_bwd_tile(d, L) > 0;
}

namespace general {

constexpr int kTileM = 64, kTileN = 64, kSlice = 32, kThreads = 128;
constexpr int kPad = 16;  // every staged row padded to a multiple of 16 elements
constexpr int64_t kScratchCap = int64_t{1} << 30;  // 1 GiB of rows a chunk, at most
// The dW product's blocks aim at this many (two per SM of an H100) by cutting
// the rows into ranges of at least kSplitMinRows; constants, so the order of
// the sums depends on the chain and the rows only, not on the card.
constexpr int kSplitTarget = 264;
constexpr int kSplitMinRows = 256;

__host__ __device__ inline int pad16(int w) { return (w + kPad - 1) / kPad * kPad; }
inline size_t al256(size_t b) { return (b + 255) / 256 * 256; }
inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One staged slice of an operand: element (i, k) of the tile at
// [i * kStride + k] when k is contiguous (kKInner), else at [k * kStride + i];
// rows kVec elements (16 bytes) longer than their data, so that the eight
// rows one ldmatrix reads fall on distinct banks.
template <typename T, bool kKInner>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kOuter = kKInner ? kTileM : kSlice;
  static constexpr int kInner = kKInner ? kSlice : kTileM;
  static constexpr int kStride = kInner + kVec;
  static constexpr int kElems = kOuter * kStride;
};

// Stages the slice of an operand with i in [i0, i0 + 64) and k in [k0, k0 +
// 32): element (i, k) at g[i * ld + k] (kKInner) or g[k * ld + i]. A 16-byte
// piece whose i or k lies past i_end or k_end is zero-filled: the contiguous
// index's bound is a padded width or lies inside the zero padding, so a piece
// is read whole or not at all.
template <typename T, bool kKInner>
__device__ __forceinline__ void stage(T* s, const T* g, int64_t ld, int i0, int i_end, int k0,
                                      int k_end) {
  using TL = Tile<T, kKInner>;
  constexpr int kPerRow = TL::kInner / TL::kVec;
  constexpr int kChunks = TL::kOuter * kPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int o = c / kPerRow, e = (c - o * kPerRow) * TL::kVec;
    const int go = (kKInner ? i0 : k0) + o, gi = (kKInner ? k0 : i0) + e;
    const bool in = go < (kKInner ? i_end : k_end) && gi < (kKInner ? k_end : i_end);
    const T* src = in ? g + static_cast<int64_t>(go) * ld + gi : g;
    cp_async16(s + o * TL::kStride + e, src, in ? 16 : 0);
  }
}

// What a product's epilogue does with its sums v at (row, col).
enum Epilogue : int {
  kHidden = 0,  // relu(v + b), in the compute dtype, to the next layer's input
  kLast = 1,    // v + b, f32, to y
  kDh = 2,      // v where the layer's input is > 0, in the compute dtype, and its column sums
  kDx = 3,      // v, f32, to dx
  kDw = 4,      // v, f32, to the partial sums of blockIdx.z's rows
};

// One product out = A . B (A: m x k, B: k x n) and its epilogue.
struct Gemm {
  const void* a;
  int64_t lda;
  int a_end;  // A's i (row) bound
  const void* b;
  int64_t ldb;
  int b_end;  // B's i (column) bound
  int k_end;  // k of the product: its rows past it read zero
  int k_split;  // k of one blockIdx.z, a multiple of kSlice
  int m, n;   // rows and real columns of the output
  int n_out;  // columns written by kHidden and kDh (the padded width)
  const float* bias;  // kHidden, kLast: padded with zeros
  const void* mask;   // kDh: the layer's input, at row stride ldm
  int64_t ldm;
  void* out;
  int64_t ldo;
  int64_t out_z;  // kDw: blockIdx.z's partial sums at out + z * out_z
  float* colsum;  // kDh: the block's column sums at colsum[blockIdx.x * ldc + col]
  int64_t ldc;
};

// The f32 products (the bf16 ones are mlp_wgmma_kernel's).
template <int kEpi, bool kAK, bool kBK>
__global__ void __launch_bounds__(kThreads) mlp_gemm_kernel(Gemm p) {
  using T = float;
  constexpr int kA = Tile<T, kAK>::kElems, kB = Tile<T, kBK>::kElems;
  __shared__ __align__(16) T smem[2 * (kA + kB)];
  __shared__ float sums[16][kTileN];
  const T* A = static_cast<const T*>(p.a);
  const T* B = static_cast<const T*>(p.b);
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int k0 = blockIdx.z * p.k_split;
  const int k1 = min(p.k_end, k0 + p.k_split);
  const int slices = k1 > k0 ? (k1 - k0 + kSlice - 1) / kSlice : 0;

  float acc[8][4];  // sum i at acc[i / 4][i % 4]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (slices > 0) {
    stage<T, kAK>(smem, A, p.lda, m0, p.a_end, k0, k1);
    stage<T, kBK>(smem + kA, B, p.ldb, n0, p.b_end, k0, k1);
  }
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      T* next = smem + ((s + 1) & 1) * (kA + kB);
      const int ks = k0 + (s + 1) * kSlice;
      stage<T, kAK>(next, A, p.lda, m0, p.a_end, ks, k1);
      stage<T, kBK>(next + kA, B, p.ldb, n0, p.b_end, ks, k1);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this slice has landed
    __syncthreads();
    const T* As = smem + (s & 1) * (kA + kB);
    const T* Bs = As + kA;
    {  // k ascending over the real depth only: the FMA kernel's order
      constexpr int SA = Tile<T, kAK>::kStride, SB = Tile<T, kBK>::kStride;
      const int cg = threadIdx.x & 7, rg = threadIdx.x >> 3;
      const int kc = min(kSlice, k1 - (k0 + s * kSlice));
      for (int kk = 0; kk < kc; ++kk) {
        float av[4], bv[8];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          av[q] = to_f32(kAK ? As[(4 * rg + q) * SA + kk] : As[kk * SA + 4 * rg + q]);
#pragma unroll
        for (int c = 0; c < 8; ++c)
          bv[c] = to_f32(kBK ? Bs[(8 * cg + c) * SB + kk] : Bs[kk * SB + 8 * cg + c]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[2 * q + c / 4][c % 4] = fmaf(av[q], bv[c], acc[2 * q + c / 4][c % 4]);
      }
    }
    __syncthreads();  // the buffer is free for the slice after next
  }
  cp_async_wait<0>();

  // (row, col) of the tile for sum i: the thread's 4 x 8 block
  auto at = [&](int i, int& r, int& c) {
    r = 4 * (threadIdx.x >> 3) + (i >> 3);
    c = 8 * (threadIdx.x & 7) + (i & 7);
  };
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int r, c;
    at(i, r, c);
    const int row = m0 + r, col = n0 + c;
    const float v = acc[i >> 2][i & 3];
    if constexpr (kEpi == kHidden) {
      if (row < p.m && col < p.n_out)
        static_cast<T*>(p.out)[row * p.ldo + col] = from_f32<T>(fmaxf(v + p.bias[col], 0.f));
    } else if constexpr (kEpi == kLast) {
      if (row < p.m && col < p.n) static_cast<float*>(p.out)[row * p.ldo + col] = v + p.bias[col];
    } else if constexpr (kEpi == kDx) {
      if (row < p.m && col < p.n) static_cast<float*>(p.out)[row * p.ldo + col] = v;
    } else if constexpr (kEpi == kDw) {
      if (row < p.m && col < p.n)
        static_cast<float*>(p.out)[blockIdx.z * p.out_z + row * p.ldo + col] = v;
    } else {
      float h = 0.f;
      if (row < p.m && col < p.n_out) {
        h = to_f32(static_cast<const T*>(p.mask)[row * p.ldm + col]) > 0.f ? v : 0.f;
        static_cast<T*>(p.out)[row * p.ldo + col] = from_f32<T>(h);
      }
      acc[i >> 2][i & 3] = h;  // for the column sums
    }
  }
  if constexpr (kEpi == kDh) {
    // the column sums of the block's rows, in a fixed order
#pragma unroll
    for (int c = 0; c < 8; ++c)
      sums[threadIdx.x >> 3][8 * (threadIdx.x & 7) + c] =
          acc[c / 4][c % 4] + acc[2 + c / 4][c % 4] + acc[4 + c / 4][c % 4] +
          acc[6 + c / 4][c % 4];
    __syncthreads();
    if (threadIdx.x < kTileN && n0 + threadIdx.x < p.n_out) {
      constexpr int kParts = kThreads / 8;
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kParts; ++w) t += sums[w][threadIdx.x];
      p.colsum[blockIdx.x * p.ldc + n0 + threadIdx.x] = t;
    }
  }
}

// The bf16 products on the H100's warpgroup instructions: an output tile of
// 128 x 256 a block of two warpgroups (each m64n256k16 over its 64 rows),
// the depth in slices of 64 through a ring of kWgStages slices that TMA
// fills (one thread issues each slice's boxes; the slice's mbarrier counts
// its bytes), 128-byte swizzled (wgmma_bf16.cuh). kWgStages - 1 slices are in
// flight while one is multiplied; slice s - 1's products may still run
// (one wgmma group in flight), so a buffer is refilled only after both
// warpgroups waited for its group: one block barrier a slice. TMA fills the
// edges with zeros: rows past the output's, k past the product's depth (the
// dW product's row ranges are whole slices, so a range never reads the
// next one's rows). The sums are then staged through shared memory for the
// epilogue, which writes whole rows (16-byte pieces of bf16 where it writes
// the compute dtype). The epilogues are mlp_gemm_kernel's; kDh's column sums
// add the block's 128 rows in row order.
constexpr int kWgM = 128, kWgN = 256, kWgK = 64, kWgStages = 4, kWgThreads = 256;
constexpr int kWgTileBytes = (kWgM + kWgN) * kWgK * 2;  // one slice of both operands
constexpr int kWgSmem = kWgStages * kWgTileBytes + 1024;  // + the 1,024-byte alignment
constexpr int kWgLd = kWgN + 4;  // the staged sums' row stride, floats

template <int kEpi, bool kAK, bool kBK>
__global__ void __launch_bounds__(kWgThreads)
mlp_wgmma_kernel(const Gemm p, const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb) {
  extern __shared__ __align__(1024) unsigned char wg_raw[];
  __shared__ __align__(8) uint64_t full[kWgStages];
  unsigned char* wg_smem = wg_raw + ((1024 - (smem_addr(wg_raw) & 1023)) & 1023);
  // the column tiles of one row tile run side by side (blockIdx.x), so A is
  // read from device memory once
  const int m0 = blockIdx.y * kWgM, n0 = blockIdx.x * kWgN;
  const int k0 = blockIdx.z * p.k_split;
  const int k1 = min(p.k_end, k0 + p.k_split);
  const int slices = k1 > k0 ? (k1 - k0 + kWgK - 1) / kWgK : 0;
  const int wgi = threadIdx.x >> 7;  // this warpgroup's 64 rows
  if (threadIdx.x == 0) {
    for (int b = 0; b < kWgStages; ++b) wg::bar_init(&full[b], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  auto tile_a = [&](int s) { return wg_smem + (s % kWgStages) * kWgTileBytes; };
  auto issue = [&](int s) {  // slice s's boxes (thread 0)
    unsigned char* a = tile_a(s);
    unsigned char* b = a + kWgM * kWgK * 2;
    uint64_t* bar = &full[s % kWgStages];
    const int ks = k0 + s * kWgK;
    wg::bar_expect(bar, kWgTileBytes);
    if (kAK) {
      wg::tma_load(a, &ta, ks, m0, bar);
    } else {
      for (int q = 0; q < kWgM / 64; ++q) wg::tma_load(a + q * 8192, &ta, m0 + 64 * q, ks, bar);
    }
    if (kBK) {
      wg::tma_load(b, &tb, ks, n0, bar);
    } else {
      for (int q = 0; q < kWgN / 64; ++q) wg::tma_load(b + q * 8192, &tb, n0 + 64 * q, ks, bar);
    }
  };
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  if (threadIdx.x == 0)
    for (int s = 0; s + 1 < kWgStages && s < slices; ++s) issue(s);
  for (int s = 0; s < slices; ++s) {
    wg::bar_wait(&full[s % kWgStages], (s / kWgStages) & 1);
    const unsigned char* a = tile_a(s);
    const unsigned char* b = a + kWgM * kWgK * 2;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kWgK / 16; ++kk) {
      // K-major: 32 bytes a k16 step (LBO unused); MN-major: 2,048 (16 k-rows)
      const uint64_t da = kAK ? wg::desc(a + wgi * 8192 + 32 * kk, 16, 1024)
                              : wg::desc(a + wgi * 8192 + 2048 * kk, 8192, 1024);
      const uint64_t db = kBK ? wg::desc(b + 32 * kk, 16, 1024)
                              : wg::desc(b + 2048 * kk, 8192, 1024);
      wg::mma_m64n256k16<kAK ? 0 : 1, kBK ? 0 : 1>(acc, da, db);
    }
    wg::commit();
    wg::wait<1>();  // slice s - 1's products are done
    __syncthreads();  // in both warpgroups: its buffer takes slice s + kWgStages - 1
    if (threadIdx.x == 0 && s + kWgStages - 1 < slices) issue(s + kWgStages - 1);
  }
  wg::wait<0>();
  __syncthreads();  // the ring is free: stage the sums
  float* sums = reinterpret_cast<float*>(wg_smem);
  {
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int r = 64 * wgi + 16 * w + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kWgN / 8; ++j) {
      *reinterpret_cast<float2*>(sums + r * kWgLd + 8 * j + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(sums + (r + 8) * kWgLd + 8 * j + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  const int rows = min(kWgM, p.m - m0);
  if constexpr (kEpi == kHidden || kEpi == kDh) {
    // 8 columns (16 bytes of bf16) a thread-step; n_out and ldo multiples of 16
    const int cols = min(kWgN, p.n_out - n0);
    auto* out = static_cast<__nv_bfloat16*>(p.out);
    const int per = cols / 8;
    for (int e = threadIdx.x; e < rows * per; e += kWgThreads) {
      const int r = e / per, c = (e - r * per) * 8;
      float* v = sums + r * kWgLd + c;
      const int64_t row = m0 + r;
      if constexpr (kEpi == kHidden) {
        const float4 b0 = *reinterpret_cast<const float4*>(p.bias + n0 + c);
        const float4 b1 = *reinterpret_cast<const float4*>(p.bias + n0 + c + 4);
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = fmaxf(v[q] + bb[q], 0.f);
      } else {
        const uint4 mk = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(p.mask) + row * p.ldm + n0 + c);
        const auto* m8 = reinterpret_cast<const __nv_bfloat16*>(&mk);
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = __bfloat162float(m8[q]) > 0.f ? v[q] : 0.f;
      }
      uint4 pk;
      pk.x = pack_bf16x2(v[0], v[1]);
      pk.y = pack_bf16x2(v[2], v[3]);
      pk.z = pack_bf16x2(v[4], v[5]);
      pk.w = pack_bf16x2(v[6], v[7]);
      *reinterpret_cast<uint4*>(out + row * p.ldo + n0 + c) = pk;
    }
    if constexpr (kEpi == kDh) {
      __syncthreads();  // the masked sums, summed down each column in row order
      for (int c = threadIdx.x; c < cols; c += kWgThreads) {
        float t = 0.f;
        for (int r = 0; r < rows; ++r) t += sums[r * kWgLd + c];
        p.colsum[blockIdx.y * p.ldc + n0 + c] = t;
      }
    }
  } else {
    // f32 rows: y (+ b), dx, dW's partial sums; a warp along a row segment
    const int cols = min(kWgN, p.n - n0);
    float* out = static_cast<float*>(p.out) + (kEpi == kDw ? blockIdx.z * p.out_z : 0);
    for (int e = threadIdx.x; e < rows * kWgN; e += kWgThreads) {
      const int r = e / kWgN, c = e - r * kWgN;
      if (c < cols) {
        float v = sums[r * kWgLd + c];
        if constexpr (kEpi == kLast) v += p.bias[n0 + c];
        out[static_cast<int64_t>(m0 + r) * p.ldo + n0 + c] = v;
      }
    }
  }
}

// W_l (din x dout f32) and b_l into the packed layout: W as [pad(din)]
// [pad(dout)] in the compute dtype, b as pad(dout) floats, zeros around. A
// block per packed row (the last block the bias), a thread per column.
template <typename T>
__global__ void __launch_bounds__(256)
mlp_pack_kernel(const float* __restrict__ w, const float* __restrict__ b, int din, int dout,
                T* __restrict__ wp, float* __restrict__ bp) {
  const int r = blockIdx.x, np = pad16(dout);
  for (int c = threadIdx.x; c < np; c += blockDim.x) {
    if (r == pad16(din))
      bp[c] = c < dout ? b[c] : 0.f;
    else
      wp[static_cast<int64_t>(r) * np + c] =
          from_f32<T>(r < din && c < dout ? w[static_cast<int64_t>(r) * dout + c] : 0.f);
  }
}

// rows x w f32 (row stride lds) into rows x wp in the compute dtype, zeros
// past w; a block per 64 rows, a thread per column. With colsum, the f32 sum
// of each column over the block's rows, in row order, at colsum[block * wp].
template <typename T>
__global__ void __launch_bounds__(256)
mlp_pad_rows_kernel(const float* __restrict__ src, int64_t lds, int rows, int w,
                    T* __restrict__ dst, int wp, float* __restrict__ colsum) {
  const int r0 = blockIdx.x * 64, r1 = min(r0 + 64, rows);
  for (int c = threadIdx.x; c < wp; c += blockDim.x) {
    float s = 0.f;
    for (int r = r0; r < r1; ++r) {
      const float v = c < w ? src[r * lds + c] : 0.f;
      dst[static_cast<int64_t>(r) * wp + c] = from_f32<T>(v);
      s += v;
    }
    if (colsum != nullptr) colsum[static_cast<int64_t>(blockIdx.x) * wp + c] = s;
  }
}

// out[c] (+)= sum over r, in order, of part[r * ld + c], for c < count.
__global__ void __launch_bounds__(256)
mlp_sum_rows_kernel(const float* __restrict__ part, int64_t ld, int rows, int count,
                    float* __restrict__ out, int accumulate) {
  const int c = blockIdx.x * 256 + threadIdx.x;
  if (c >= count) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[r * ld + c];
  out[c] = accumulate ? out[c] + s : s;
}

// ------------------------------------------------------------------ host side

inline size_t elem_bytes(bool bf16) { return bf16 ? 2 : 4; }

// Bytes of the packed weights and biases of the chain.
inline size_t packed_bytes(const int* d, int L, bool bf16) {
  size_t b = 0;
  for (int l = 0; l < L; ++l)
    b += al256(static_cast<size_t>(pad16(d[l])) * pad16(d[l + 1]) * elem_bytes(bf16)) +
         al256(sizeof(float) * pad16(d[l + 1]));
  return b;
}

// Rows per chunk: a multiple of 64 whose rows take at most kScratchCap
// bytes at per_row bytes a row (at least 64 rows), no more than n needs.
inline int64_t chunk_rows(int64_t n, size_t per_row) {
  int64_t rows = static_cast<int64_t>(kScratchCap / std::max<size_t>(per_row, 1)) / 64 * 64;
  rows = std::max<int64_t>(rows, 64);
  return std::min<int64_t>(rows, std::max<int64_t>(ceil_div(n, 64) * 64, 64));
}

// The widest padded hidden layer (0 for one layer).
inline int widest_hidden(const int* d, int L) {
  int w = 0;
  for (int l = 1; l < L; ++l) w = std::max(w, pad16(d[l]));
  return w;
}

// The widest padded layer output (hidden or last): the backward's dh.
inline int widest_output(const int* d, int L) {
  int w = 0;
  for (int l = 1; l <= L; ++l) w = std::max(w, pad16(d[l]));
  return w;
}

inline int64_t fwd_chunk(const int* d, int L, bool bf16, int64_t n) {
  const size_t e = elem_bytes(bf16);
  return chunk_rows(n, e * (pad16(d[0]) + 2 * static_cast<size_t>(widest_hidden(d, L))));
}

inline size_t fwd_scratch_bytes(const int* d, int L, bool bf16, int64_t n) {
  const size_t e = elem_bytes(bf16), rows = static_cast<size_t>(fwd_chunk(d, L, bf16, n));
  return packed_bytes(d, L, bf16) + al256(rows * pad16(d[0]) * e) +
         2 * al256(rows * widest_hidden(d, L) * e);
}

// Row ranges (blockIdx.z) of the dW product of a din x dout layer over rows,
// in the product kernel's tiles and slices (bf16: 128 x 256, 64 deep; f32:
// 64 x 64, 32 deep).
inline int dw_splits(int din, int dout, int64_t rows, int& k_split, bool bf16) {
  const int tm = bf16 ? kWgM : kTileM, tn = bf16 ? kWgN : kTileN, ks = bf16 ? kWgK : kSlice;
  const int64_t tiles = ceil_div(din, tm) * ceil_div(dout, tn);
  int64_t want = std::max<int64_t>(1, ceil_div(kSplitTarget, tiles));
  want = std::min<int64_t>(want, std::max<int64_t>(1, ceil_div(rows, kSplitMinRows)));
  k_split = static_cast<int>(ceil_div(ceil_div(rows, want), ks) * ks);
  return static_cast<int>(ceil_div(rows, k_split));
}

inline int64_t bwd_chunk(const int* d, int L, bool bf16, int64_t n) {
  const size_t e = elem_bytes(bf16);
  size_t per_row = 2 * e * widest_output(d, L) + sizeof(float) * widest_output(d, L) / 64 + 1;
  for (int l = 0; l < L; ++l) per_row += e * pad16(d[l]);
  return chunk_rows(n, per_row);
}

inline size_t dw_partial_floats(const int* d, int L, int64_t rows, bool bf16) {
  size_t most = 0;
  for (int l = 0; l < L; ++l) {
    int k_split = 0;
    const int z = dw_splits(d[l], d[l + 1], rows, k_split, bf16);
    most = std::max(most, static_cast<size_t>(z) * d[l] * d[l + 1]);
  }
  return most;
}

inline size_t bwd_scratch_bytes(const int* d, int L, bool bf16, int64_t n) {
  const size_t e = elem_bytes(bf16);
  const int64_t rows = bwd_chunk(d, L, bf16, n);
  const size_t r = static_cast<size_t>(rows);
  size_t b = packed_bytes(d, L, bf16);
  for (int l = 0; l < L; ++l) b += al256(r * pad16(d[l]) * e);
  b += 2 * al256(r * widest_output(d, L) * e);
  b += al256(sizeof(float) * ceil_div(rows, 64) * widest_output(d, L));
  b += al256(sizeof(float) * dw_partial_floats(d, L, rows, bf16));
  return b;
}

// Carves consecutive 256-aligned pieces out of the scratch.
struct Carve {
  char* at;
  template <typename U>
  U* take(size_t count) {
    U* p = reinterpret_cast<U*>(at);
    at += al256(count * sizeof(U));
    return p;
  }
};

template <typename T>
struct Packed {
  std::vector<const T*> w;
  std::vector<const float*> b;
};

template <typename T>
cudaError_t pack_weights(const float* params, const int* d, int L, Carve& cv, Packed<T>& pk,
                         cudaStream_t stream) {
  int64_t goff = 0;
  for (int l = 0; l < L; ++l) {
    T* w = cv.take<T>(static_cast<size_t>(pad16(d[l])) * pad16(d[l + 1]));
    float* b = cv.take<float>(pad16(d[l + 1]));
    mlp_pack_kernel<T><<<pad16(d[l]) + 1, 256, 0, stream>>>(params + goff,
                                                  params + goff + int64_t{d[l]} * d[l + 1],
                                                  d[l], d[l + 1], w, b);
    pk.w.push_back(w);
    pk.b.push_back(b);
    goff += int64_t{d[l]} * d[l + 1] + d[l + 1];
  }
  return cudaGetLastError();
}

// Output tile rows and columns of the product kernel of the compute dtype:
// bf16 the warpgroup kernel's 128 x 256, f32 the FMA kernel's 64 x 64.
template <typename T>
constexpr int tile_m() { return sizeof(T) == 2 ? kWgM : kTileM; }
template <typename T>
constexpr int tile_n() { return sizeof(T) == 2 ? kWgN : kTileN; }

// Launches one product over the output's columns (n, or n_out where the
// epilogue writes the padded width) and grid_z ranges of k.
template <typename T, int kEpi, bool kAK, bool kBK>
cudaError_t launch_gemm(const Gemm& g, int grid_z, cudaStream_t stream) {
  const int cols = kEpi == kHidden || kEpi == kDh ? g.n_out : g.n;
  const unsigned row_tiles = static_cast<unsigned>(ceil_div(g.m, tile_m<T>()));
  const unsigned col_tiles = static_cast<unsigned>(ceil_div(cols, tile_n<T>()));
  if constexpr (sizeof(T) == 2) {  // column tiles along x: see mlp_wgmma_kernel
    // K-major operands: one box of 64 k x the tile's rows; MN-major: 64 x 64
    CUtensorMap ta, tb;
    cudaError_t err = kAK ? wg::tensor_map(&ta, g.a, g.lda, g.a_end, g.lda, kWgK, kWgM)
                          : wg::tensor_map(&ta, g.a, g.lda, g.k_end, g.lda, 64, kWgK);
    if (err != cudaSuccess) return err;
    err = kBK ? wg::tensor_map(&tb, g.b, g.ldb, g.b_end, g.ldb, kWgK, kWgN)
              : wg::tensor_map(&tb, g.b, g.ldb, g.k_end, g.ldb, 64, kWgK);
    if (err != cudaSuccess) return err;
    auto kernel = mlp_wgmma_kernel<kEpi, kAK, kBK>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(col_tiles, row_tiles, static_cast<unsigned>(grid_z)), kWgThreads, kWgSmem,
             stream>>>(g, ta, tb);
  } else {
    mlp_gemm_kernel<kEpi, kAK, kBK><<<dim3(row_tiles, col_tiles, static_cast<unsigned>(grid_z)),
                                      kThreads, 0, stream>>>(g);
  }
  return cudaGetLastError();
}

// The forward product of layer l over `rows` rows: in (rows x pad(d_l), the
// compute dtype) -> out. Hidden layers write rows x pad(d_l+1) in the
// compute dtype; the last layer f32 rows x d_L at row stride d_L.
template <typename T>
cudaError_t forward_layer(const T* in, const Packed<T>& pk, const int* d, int L, int l, int rows,
                   void* out, cudaStream_t stream) {
  Gemm g{};
  g.a = in;
  g.lda = pad16(d[l]);
  g.a_end = rows;
  g.b = pk.w[l];
  g.ldb = pad16(d[l + 1]);
  g.b_end = pad16(d[l + 1]);
  g.k_end = d[l];
  g.k_split = std::max(g.k_end, 1);
  g.m = rows;
  g.n = d[l + 1];
  g.bias = pk.b[l];
  g.out = out;
  if (l + 1 == L) {
    g.ldo = d[L];
    return launch_gemm<T, kLast, true, false>(g, 1, stream);
  }
  g.n_out = pad16(d[l + 1]);
  g.ldo = g.n_out;
  return launch_gemm<T, kHidden, true, false>(g, 1, stream);
}

// x rows [r0, r0 + rows) into the compute dtype, padded.
template <typename T>
void stage_rows_padded(const float* src, int width, int64_t r0, int rows, T* dst,
                       float* colsum, cudaStream_t stream) {
  mlp_pad_rows_kernel<T><<<static_cast<unsigned>(ceil_div(rows, 64)), 256, 0, stream>>>(
      src + r0 * width, width, rows, width, dst, pad16(width), colsum);
}

// K1's general route: y = chain(x), chunk by chunk.
template <typename T>
cudaError_t forward(const float* x, const float* params, float* y, int64_t n, const int* d,
                    int L, void* scratch, cudaStream_t stream) {
  Carve cv{static_cast<char*>(scratch)};
  Packed<T> pk;
  cudaError_t err = pack_weights<T>(params, d, L, cv, pk, stream);
  if (err != cudaSuccess) return err;
  const int64_t chunk = fwd_chunk(d, L, sizeof(T) == 2, n);
  const int wh = widest_hidden(d, L);
  T* xs = cv.take<T>(static_cast<size_t>(chunk) * pad16(d[0]));
  T* h[2] = {cv.take<T>(static_cast<size_t>(chunk) * wh), cv.take<T>(static_cast<size_t>(chunk) * wh)};
  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(std::min(chunk, n - r0));
    stage_rows_padded<T>(x, d[0], r0, rows, xs, nullptr, stream);
    const T* in = xs;
    for (int l = 0; l < L; ++l) {
      void* out = l + 1 == L ? static_cast<void*>(y + r0 * d[L]) : static_cast<void*>(h[l & 1]);
      err = forward_layer<T>(in, pk, d, L, l, rows, out, stream);
      if (err != cudaSuccess) return err;
      in = h[l & 1];
    }
  }
  return cudaSuccess;
}

// K2's general route: dx (unless null) and dparams (the params layout),
// chunk by chunk; the recompute is forward_layer, K1's own code.
template <typename T>
cudaError_t backward(const float* x, const float* g_out, const float* params, float* dx,
                     float* dparams, int64_t n, const int* d, int L, void* scratch,
                     cudaStream_t stream) {
  Carve cv{static_cast<char*>(scratch)};
  Packed<T> pk;
  cudaError_t err = pack_weights<T>(params, d, L, cv, pk, stream);
  if (err != cudaSuccess) return err;
  const int64_t chunk = bwd_chunk(d, L, sizeof(T) == 2, n);
  const int wo = widest_output(d, L);
  std::vector<T*> a(L);
  for (int l = 0; l < L; ++l) a[l] = cv.take<T>(static_cast<size_t>(chunk) * pad16(d[l]));
  T* dh[2] = {cv.take<T>(static_cast<size_t>(chunk) * wo), cv.take<T>(static_cast<size_t>(chunk) * wo)};
  float* colsum = cv.take<float>(static_cast<size_t>(ceil_div(chunk, 64)) * wo);
  float* part = cv.take<float>(dw_partial_floats(d, L, chunk, sizeof(T) == 2));
  std::vector<int64_t> goff(L);
  for (int l = 0, o = 0; l < L; ++l) {
    goff[l] = o;
    o += d[l] * d[l + 1] + d[l + 1];
  }
  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(std::min(chunk, n - r0));
    const int acc = r0 > 0;
    // the column sums' row blocks: mlp_pad_rows_kernel's 64, the dh product's tile
    const int pad_blocks = static_cast<int>(ceil_div(rows, 64));
    const int dh_blocks = static_cast<int>(ceil_div(rows, tile_m<T>()));
    stage_rows_padded<T>(x, d[0], r0, rows, a[0], nullptr, stream);
    for (int l = 0; l + 1 < L; ++l) {
      err = forward_layer<T>(a[l], pk, d, L, l, rows, a[l + 1], stream);
      if (err != cudaSuccess) return err;
    }
    // dh of the last layer: g, rounded; db_{L-1} its column sums
    stage_rows_padded<T>(g_out, d[L], r0, rows, dh[0], colsum, stream);
    mlp_sum_rows_kernel<<<static_cast<unsigned>(ceil_div(d[L], 256)), 256, 0, stream>>>(
        colsum, pad16(d[L]), pad_blocks, d[L], dparams + goff[L - 1] + int64_t{d[L - 1]} * d[L],
        acc);
    int cur = 0;
    for (int l = L - 1; l >= 0; --l) {
      const int din = d[l], dout = d[l + 1];
      {  // dW_l = a_l^T . dh over the chunk's rows, in row ranges, then summed in order
        Gemm g{};
        g.a = a[l];
        g.lda = pad16(din);
        g.a_end = pad16(din);
        g.b = dh[cur];
        g.ldb = pad16(dout);
        g.b_end = pad16(dout);
        g.k_end = rows;
        const int z = dw_splits(din, dout, rows, g.k_split, sizeof(T) == 2);
        g.m = din;
        g.n = dout;
        g.out = part;
        g.ldo = dout;
        g.out_z = int64_t{din} * dout;
        err = launch_gemm<T, kDw, false, false>(g, z, stream);
        if (err != cudaSuccess) return err;
        mlp_sum_rows_kernel<<<static_cast<unsigned>(ceil_div(g.out_z, 256)), 256, 0, stream>>>(
            part, g.out_z, z, static_cast<int>(g.out_z), dparams + goff[l], acc);
      }
      if (l == 0 && dx == nullptr) break;
      Gemm g{};  // dh . W_l^T
      g.a = dh[cur];
      g.lda = pad16(dout);
      g.a_end = rows;
      g.b = pk.w[l];
      g.ldb = pad16(dout);
      g.b_end = pad16(din);
      g.k_end = dout;
      g.k_split = dout;
      g.m = rows;
      g.n = din;
      if (l == 0) {
        g.out = dx + r0 * din;
        g.ldo = din;
        err = launch_gemm<T, kDx, true, true>(g, 1, stream);
        if (err != cudaSuccess) return err;
        break;
      }
      g.n_out = pad16(din);
      g.mask = a[l];
      g.ldm = pad16(din);
      g.out = dh[cur ^ 1];
      g.ldo = pad16(din);
      g.colsum = colsum;
      g.ldc = pad16(din);
      err = launch_gemm<T, kDh, true, true>(g, 1, stream);
      if (err != cudaSuccess) return err;
      mlp_sum_rows_kernel<<<static_cast<unsigned>(ceil_div(din, 256)), 256, 0, stream>>>(
          colsum, pad16(din), dh_blocks, din, dparams + goff[l - 1] + int64_t{d[l - 1]} * din,
          acc);
      cur ^= 1;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace general
}  // namespace umhs
