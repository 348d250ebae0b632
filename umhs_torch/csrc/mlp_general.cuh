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
// shared memory for whole-row stores; f32 mode, mlp_gemm_kernel: up to
// 128 x 128 tiles, fused multiply-adds, a thread 8 x 8 sums from float4
// loads of k-outer staged slices, k ascending from +0 and then + b: the FMA
// kernel's sum order, so an f32 chain gets the FMA kernel's bits on either
// route (the first product reads x as it lies). An operand lies k
// contiguous ([i][k]) or i contiguous ([k][i]); both kernels take either.
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
// L2 (48 KB a 64-deep slice for 2M multiply-adds). In f32 a thread issues
// four shared loads for 64 FMAs; the dW products of wide layers have few
// blocks (their row ranges are fixed, so that the sums keep their order),
// which leaves the card's SMs unevenly loaded.
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

// The f32 dW product's row ranges are cut for these tiles (the first f32
// kernel's 64 x 64 output tiles, 32 deep), whatever tile runs them, so that
// its sums keep their order.
constexpr int kSplitTileM = 64, kSplitTileN = 64, kSplitSlice = 32;
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
  int k_split;  // k of one blockIdx.z, a multiple of the product's slice
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

// The f32 products (the bf16 ones are mlp_wgmma_kernel's), on the FMA units.
// A warp is 4 x 8 threads and a thread holds a kTM x kTN block of sums in
// registers (8 x 8, or 4 x 8 where a product has few output tiles: the dW
// products of wide layers, whose row ranges are fixed, so that more warps
// share the card); rows {4 ty + 16 q + i} of its warp's 4 kTM, columns
// {4 tx + 32 q + j} of its 8 kTN. A block of kWM x kWN warps computes the
// output tile (128 x 128, 128 x 64 or 128 x 32 for a narrow output, 64 x
// 64; launch_gemm picks). Each slice of kFk = 32 k is staged k-outer in
// shared memory (s[k * ld + i], rows kFPad floats longer than the tile), so
// that a thread reads its A and B values of one k as float4 loads (four
// for 64 FMAs at 8 x 8), and a warp's loads fall on distinct banks or
// broadcast. An operand that lies i-contiguous ([k][i]) is staged by
// 16-byte cp.async; a k-contiguous one ([i][k]) by 4-byte cp.async that
// transpose it on the way (a warp copies 8 k of 4 rows: one 32-byte sector
// a row, 32 distinct banks), with every element bounded on its own, so such
// an operand may be a raw input at any row stride. kFStages slices are in
// flight (cp.async groups), one block barrier a slice. The sums then go
// through shared memory, and the epilogue writes whole rows: 16-byte pieces
// where it writes the padded width, a warp along a row segment elsewhere.
//
// Each sum is one fmaf chain over k ascending from +0, over the product's
// real depth only (a slice past k_end stops at it), then + b: the order of
// the FMA kernels (mlp_fused_fwd.cu) and of the first f32 kernel (64 x 64
// tiles), so any tile gives the same bits. kDh's column sums keep that
// kernel's grouping: per 64-row group, four consecutive rows added in
// order, then the 16 such sums added from +0 in row order (a row past m
// adds +0), one row of sums per 64-row group.
constexpr int kFk = 32, kFStages = 3, kFPad = 4;

template <int kTM, int kTN, int kWM, int kWN>
struct FTile {
  static constexpr int kM = kWM * 4 * kTM, kN = kWN * 8 * kTN, kThreads = 32 * kWM * kWN;
  static constexpr int kLdA = kM + kFPad, kLdB = kN + kFPad, kLdS = kN + kFPad;
  static constexpr int kStage = kFk * (kLdA + kLdB);  // floats of one slice, both operands
  static constexpr int kRing = kFStages * kStage;
  static constexpr int kSmem = 4 * (kRing > kM * kLdS ? kRing : kM * kLdS);
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// Stages i in [i0, i0 + kDim) and k in [k0, k0 + kFk) of an operand whose
// element (i, k) lies at g[i * ldg + k] (kKInner) or g[k * ldg + i], into
// s[k * ld + i]; past i_end or k_end, zeros. Each thread's pieces sit at
// offsets fixed at compile time from its own first one. The 16-byte path
// reads a piece whole or not at all: its i_end is a multiple of 4 (a
// padded width).
template <int kDim, int kThreads, bool kKInner>
__device__ __forceinline__ void fstage(float* s, int ld, const float* g, int64_t ldg, int i0,
                                       int i_end, int k0, int k_end) {
  const int t = threadIdx.x;
  if constexpr (kKInner) {
    static_assert((8 * kDim) % kThreads == 0 && (kFk * kDim) % kThreads == 0, "tile");
    const int ti = t >> 3, tk = t & 7;
#pragma unroll
    for (int q = 0; q < kFk * kDim / kThreads; ++q) {
      const int i = (q * kThreads) % (8 * kDim) / 8 + ti;
      const int k = (q * kThreads) / (8 * kDim) * 8 + tk;
      const bool in = i0 + i < i_end && k0 + k < k_end;
      const float* src = in ? g + static_cast<int64_t>(i0 + i) * ldg + (k0 + k) : g;
      cp_async4(s + k * ld + i, src, in ? 4 : 0);
    }
  } else {
    constexpr int kPer = kDim / 4;
    static_assert(kThreads % kPer == 0 && (kFk * kPer) % kThreads == 0, "tile");
    const int i = (t % kPer) * 4;
#pragma unroll
    for (int q = 0; q < kFk * kPer / kThreads; ++q) {
      const int k = q * (kThreads / kPer) + t / kPer;
      const bool in = i0 + i < i_end && k0 + k < k_end;
      const float* src = in ? g + static_cast<int64_t>(k0 + k) * ldg + (i0 + i) : g;
      cp_async16(s + k * ld + i, src, in ? 16 : 0);
    }
  }
}

template <int kEpi, bool kAK, bool kBK, int kTM, int kTN, int kWM, int kWN>
__global__ void __launch_bounds__(FTile<kTM, kTN, kWM, kWN>::kThreads,
                                  512 / FTile<kTM, kTN, kWM, kWN>::kThreads)
mlp_gemm_kernel(const Gemm p) {
  using TL = FTile<kTM, kTN, kWM, kWN>;
  constexpr int kM = TL::kM, kN = TL::kN, kThr = TL::kThreads;
  constexpr int kLdA = TL::kLdA, kLdB = TL::kLdB, kLdS = TL::kLdS;
  extern __shared__ __align__(16) float fsm[];
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);
  // the column tiles of one row tile run side by side (blockIdx.x), so A is
  // read from device memory once
  const int m0 = blockIdx.y * kM, n0 = blockIdx.x * kN;
  const int k0 = blockIdx.z * p.k_split;
  const int k1 = min(p.k_end, k0 + p.k_split);
  const int slices = k1 > k0 ? (k1 - k0 + kFk - 1) / kFk : 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ra = (warp % kWM) * 4 * kTM + 4 * (lane >> 3);  // rows ra + 16 q + i
  const int cb = (warp / kWM) * 8 * kTN + 4 * (lane & 7);  // columns cb + 32 q + j

  auto issue = [&](int s) {
    float* a = fsm + (s % kFStages) * TL::kStage;
    const int ks = k0 + s * kFk;
    fstage<kM, kThr, kAK>(a, kLdA, A, p.lda, m0, p.a_end, ks, k1);
    fstage<kN, kThr, kBK>(a + kFk * kLdA, kLdB, B, p.ldb, n0, p.b_end, ks, k1);
  };
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  // one k of the slice at As, Bs: the thread's A and B values, then its FMAs
  auto step = [&](const float* As, const float* Bs, int kk) {
    float av[kTM], bv[kTN];
#pragma unroll
    for (int q = 0; q < kTM / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(As + kk * kLdA + ra + 16 * q);
      av[4 * q] = v.x, av[4 * q + 1] = v.y, av[4 * q + 2] = v.z, av[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(Bs + kk * kLdB + cb + 32 * q);
      bv[4 * q] = v.x, bv[4 * q + 1] = v.y, bv[4 * q + 2] = v.z, bv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  };
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < slices) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kFStages - 2>();  // slice s has landed (this thread's copies)
    __syncthreads();  // everyone's, and slice s - 1's buffer is free
    if (s + kFStages - 1 < slices) issue(s + kFStages - 1);
    cp_async_commit();
    const float* As = fsm + (s % kFStages) * TL::kStage;
    const float* Bs = As + kFk * kLdA;
    const int kc = min(kFk, k1 - (k0 + s * kFk));  // the real depth only
    if (kc == kFk) {
#pragma unroll
      for (int kk = 0; kk < kFk; ++kk) step(As, Bs, kk);
    } else {
      for (int kk = 0; kk < kc; ++kk) step(As, Bs, kk);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the sums

  float* sums = fsm;  // kM x kN at row stride kLdS
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q)
      *reinterpret_cast<float4*>(sums + (ra + (i & 3) + (i >> 2) * 16) * kLdS + cb + 32 * q) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
  __syncthreads();
  const int rows = min(kM, p.m - m0);
  if constexpr (kEpi == kHidden || kEpi == kDh) {
    // the padded width in 16-byte pieces (n_out and ldo are multiples of 16)
    const int per = max(0, min(kN, p.n_out - n0)) / 4;
    float* out = static_cast<float*>(p.out);
    for (int e = threadIdx.x; e < rows * per; e += kThr) {
      const int r = e / per, c = (e - r * per) * 4;
      float4 v = *reinterpret_cast<const float4*>(sums + r * kLdS + c);
      const int64_t row = m0 + r;
      if constexpr (kEpi == kHidden) {
        const float4 b = *reinterpret_cast<const float4*>(p.bias + n0 + c);
        v = make_float4(fmaxf(v.x + b.x, 0.f), fmaxf(v.y + b.y, 0.f), fmaxf(v.z + b.z, 0.f),
                        fmaxf(v.w + b.w, 0.f));
      } else {
        const float4 mk = *reinterpret_cast<const float4*>(
            static_cast<const float*>(p.mask) + row * p.ldm + n0 + c);
        v = make_float4(mk.x > 0.f ? v.x : 0.f, mk.y > 0.f ? v.y : 0.f, mk.z > 0.f ? v.z : 0.f,
                        mk.w > 0.f ? v.w : 0.f);
        *reinterpret_cast<float4*>(sums + r * kLdS + c) = v;  // for the column sums
      }
      *reinterpret_cast<float4*>(out + row * p.ldo + n0 + c) = v;
    }
    if constexpr (kEpi == kDh) {
      static_assert(kM % 64 == 0, "kDh's column sums take whole 64-row groups");
      __syncthreads();
      // one row of column sums per 64-row group that holds a row < m; rows
      // past m (and columns past n_out) add +0
      for (int e = threadIdx.x; e < (kM / 64) * kN; e += kThr) {
        const int grp = e / kN, c = e - grp * kN;
        if (m0 + 64 * grp >= p.m || n0 + c >= p.n_out) continue;
        float t = 0.f;
        for (int q = 0; q < 16; ++q) {
          float h[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = 64 * grp + 4 * q + u;
            h[u] = r < rows && c < 4 * per ? sums[r * kLdS + c] : 0.f;
          }
          t += ((h[0] + h[1]) + h[2]) + h[3];
        }
        p.colsum[static_cast<int64_t>(m0 / 64 + grp) * p.ldc + n0 + c] = t;
      }
    }
  } else {
    // f32 rows at any stride: y (+ b), dx, dW's partial sums; a warp along a
    // row segment
    const int cols = min(kN, p.n - n0);
    float* out = static_cast<float*>(p.out) + (kEpi == kDw ? blockIdx.z * p.out_z : 0);
    for (int e = threadIdx.x; e < rows * cols; e += kThr) {
      const int r = e / cols, c = e - r * cols;
      float v = sums[r * kLdS + c];
      if constexpr (kEpi == kLast) v += p.bias[n0 + c];
      out[static_cast<int64_t>(m0 + r) * p.ldo + n0 + c] = v;
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
// [pad(dout)] in the compute dtype, b as pad(dout) floats, zeros around;
// with wtp, W^T as [pad(dout)][pad(din)] too (the f32 backward's dh . W^T
// reads it k-outer). A block per packed row (the last block the bias), a
// thread per column.
template <typename T>
__global__ void __launch_bounds__(256)
mlp_pack_kernel(const float* __restrict__ w, const float* __restrict__ b, int din, int dout,
                T* __restrict__ wp, float* __restrict__ bp, T* __restrict__ wtp) {
  const int r = blockIdx.x, np = pad16(dout);
  for (int c = threadIdx.x; c < np; c += blockDim.x) {
    if (r == pad16(din)) {
      bp[c] = c < dout ? b[c] : 0.f;
    } else {
      const T v = from_f32<T>(r < din && c < dout ? w[static_cast<int64_t>(r) * dout + c] : 0.f);
      wp[static_cast<int64_t>(r) * np + c] = v;
      if (wtp != nullptr) wtp[static_cast<int64_t>(c) * pad16(din) + r] = v;
    }
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

// Bytes of the packed weights (twice with their transposes) and biases of
// the chain.
inline size_t packed_bytes(const int* d, int L, bool bf16, bool transposed = false) {
  size_t b = 0;
  for (int l = 0; l < L; ++l)
    b += (transposed ? 2 : 1) *
             al256(static_cast<size_t>(pad16(d[l])) * pad16(d[l + 1]) * elem_bytes(bf16)) +
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
// cut for the tiles and slices of bf16's product kernel (128 x 256, 64 deep)
// and, in f32, for kSplitTileM x kSplitTileN, kSplitSlice deep.
inline int dw_splits(int din, int dout, int64_t rows, int& k_split, bool bf16) {
  const int tm = bf16 ? kWgM : kSplitTileM, tn = bf16 ? kWgN : kSplitTileN;
  const int ks = bf16 ? kWgK : kSplitSlice;
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
  size_t b = packed_bytes(d, L, bf16, !bf16);
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
  std::vector<const T*> w, wt;  // wt: the transposes, where packed
  std::vector<const float*> b;
};

template <typename T>
cudaError_t pack_weights(const float* params, const int* d, int L, Carve& cv, Packed<T>& pk,
                         cudaStream_t stream, bool transposed = false) {
  int64_t goff = 0;
  for (int l = 0; l < L; ++l) {
    const size_t count = static_cast<size_t>(pad16(d[l])) * pad16(d[l + 1]);
    T* w = cv.take<T>(count);
    T* wt = transposed ? cv.take<T>(count) : nullptr;
    float* b = cv.take<float>(pad16(d[l + 1]));
    mlp_pack_kernel<T><<<pad16(d[l]) + 1, 256, 0, stream>>>(params + goff,
                                                  params + goff + int64_t{d[l]} * d[l + 1],
                                                  d[l], d[l + 1], w, b, wt);
    pk.w.push_back(w);
    pk.wt.push_back(wt);
    pk.b.push_back(b);
    goff += int64_t{d[l]} * d[l + 1] + d[l + 1];
  }
  return cudaGetLastError();
}

// The f32 product kernel of one tile shape, its dynamic shared memory set.
template <int kEpi, bool kAK, bool kBK, int kTM, int kTN, int kWM, int kWN>
cudaError_t launch_ftile(const Gemm& g, int cols, int grid_z, cudaStream_t stream) {
  using TL = FTile<kTM, kTN, kWM, kWN>;
  auto kernel = mlp_gemm_kernel<kEpi, kAK, kBK, kTM, kTN, kWM, kWN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(ceil_div(cols, TL::kN)),
                static_cast<unsigned>(ceil_div(g.m, TL::kM)), static_cast<unsigned>(grid_z)),
           TL::kThreads, TL::kSmem, stream>>>(g);
  return cudaGetLastError();
}

// Launches one product over the output's columns (n, or n_out where the
// epilogue writes the padded width) and grid_z ranges of k. In f32: 128 x 32
// tiles (8 x 4 sums a thread) for at most 32 columns; else 128 x 64 (8 x 8,
// 4 warps) for at most 64 columns, else 128 x 128 (8 warps), where that
// gives kSplitTarget blocks (two an SM); else 64 x 64 with 4 x 8 sums a
// thread, 4 warps (the dW products of wide layers: few tiles, fixed row
// ranges). The bits do not depend on the tile. (On an H100 SXM at 700 W,
// umhs_torch/probes/f32_products.py: a [262,144 x 512] . [512 x 512] hidden
// layer 39.7 TFLOP/s with slices of 32 k in 3 stages, 38.9-39.1 with 16 k;
// the 512 x 512 dW over 5 row ranges 33.5 at 4 x 8 sums a thread on 4
// warps, 29.0 at 4 x 4 on 8, 31.4 at 8 x 4 on 2, 24.0 at 8 x 8 on 2.)
template <typename T, int kEpi, bool kAK, bool kBK>
cudaError_t launch_gemm(const Gemm& g, int grid_z, cudaStream_t stream) {
  const int cols = kEpi == kHidden || kEpi == kDh ? g.n_out : g.n;
  if constexpr (sizeof(T) == 2) {  // column tiles along x: see mlp_wgmma_kernel
    const unsigned row_tiles = static_cast<unsigned>(ceil_div(g.m, kWgM));
    const unsigned col_tiles = static_cast<unsigned>(ceil_div(cols, kWgN));
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
    return cudaGetLastError();
  } else {
    if (cols <= 32) return launch_ftile<kEpi, kAK, kBK, 8, 4, 4, 1>(g, cols, grid_z, stream);
    const bool narrow = cols <= 64;  // one 64-column tile: 128 x 64, 4 warps
    if (ceil_div(g.m, 128) * ceil_div(cols, narrow ? 64 : 128) * grid_z >= kSplitTarget)
      return narrow ? launch_ftile<kEpi, kAK, kBK, 8, 8, 4, 1>(g, cols, grid_z, stream)
                    : launch_ftile<kEpi, kAK, kBK, 8, 8, 4, 2>(g, cols, grid_z, stream);
    return launch_ftile<kEpi, kAK, kBK, 4, 8, 4, 1>(g, cols, grid_z, stream);
  }
}

// The forward product of layer l over `rows` rows: in (rows x d_l at row
// stride lda, the compute dtype; by default the padded stride) -> out.
// Hidden layers write rows x pad(d_l+1) in the compute dtype; the last layer
// f32 rows x d_L at row stride d_L.
template <typename T>
cudaError_t forward_layer(const T* in, const Packed<T>& pk, const int* d, int L, int l, int rows,
                   void* out, cudaStream_t stream, int64_t lda = 0) {
  Gemm g{};
  g.a = in;
  g.lda = lda > 0 ? lda : pad16(d[l]);
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
  // chunks of equal rows (whole 64-row groups), so that no chunk is a
  // sliver with too few tiles for the card; a forward row's bits do not
  // depend on its chunk
  const int64_t most = fwd_chunk(d, L, sizeof(T) == 2, n);
  const int64_t chunk = ceil_div(ceil_div(n, ceil_div(n, most)), 64) * 64;
  const int wh = widest_hidden(d, L);
  T* xs = cv.take<T>(static_cast<size_t>(most) * pad16(d[0]));
  T* h[2] = {cv.take<T>(static_cast<size_t>(most) * wh), cv.take<T>(static_cast<size_t>(most) * wh)};
  for (int64_t r0 = 0; r0 < n; r0 += chunk) {
    const int rows = static_cast<int>(std::min(chunk, n - r0));
    // f32: the first product reads x as it lies (its k-contiguous operand is
    // staged a float at a time, each bounded); bf16 rounds it into xs first
    const T* in = xs;
    if constexpr (sizeof(T) == 4) {
      in = reinterpret_cast<const T*>(x + r0 * d[0]);
    } else {
      stage_rows_padded<T>(x, d[0], r0, rows, xs, nullptr, stream);
    }
    for (int l = 0; l < L; ++l) {
      void* out = l + 1 == L ? static_cast<void*>(y + r0 * d[L]) : static_cast<void*>(h[l & 1]);
      err = forward_layer<T>(in, pk, d, L, l, rows, out, stream,
                             sizeof(T) == 4 && l == 0 ? d[0] : 0);
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
  cudaError_t err = pack_weights<T>(params, d, L, cv, pk, stream, sizeof(T) == 4);
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
    // the column sums' row blocks: mlp_pad_rows_kernel's 64; the dh product's
    // tile in bf16, its 64-row groups in f32
    const int pad_blocks = static_cast<int>(ceil_div(rows, 64));
    const int dh_blocks = static_cast<int>(ceil_div(rows, sizeof(T) == 2 ? kWgM : 64));
    // f32 with whole 16-byte pieces a row: layer 0's input is x as it lies
    const bool raw_x = sizeof(T) == 4 && d[0] % 4 == 0;
    const T* a0 = raw_x ? reinterpret_cast<const T*>(x + r0 * d[0]) : a[0];
    if (!raw_x) stage_rows_padded<T>(x, d[0], r0, rows, a[0], nullptr, stream);
    for (int l = 0; l + 1 < L; ++l) {
      err = forward_layer<T>(l == 0 ? a0 : a[l], pk, d, L, l, rows, a[l + 1], stream,
                             l == 0 && raw_x ? d[0] : 0);
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
        g.a = l == 0 ? a0 : a[l];
        g.lda = l == 0 && raw_x ? din : pad16(din);
        g.a_end = l == 0 && raw_x ? din : pad16(din);
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
      Gemm g{};  // dh . W_l^T: in f32 from the packed transpose, k-outer
      constexpr bool kBK = sizeof(T) == 2;
      g.a = dh[cur];
      g.lda = pad16(dout);
      g.a_end = rows;
      g.b = kBK ? pk.w[l] : pk.wt[l];
      g.ldb = kBK ? pad16(dout) : pad16(din);
      g.b_end = pad16(din);
      g.k_end = dout;
      g.k_split = dout;
      g.m = rows;
      g.n = din;
      if (l == 0) {
        g.out = dx + r0 * din;
        g.ldo = din;
        err = launch_gemm<T, kDx, true, kBK>(g, 1, stream);
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
      err = launch_gemm<T, kDh, true, kBK>(g, 1, stream);
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
