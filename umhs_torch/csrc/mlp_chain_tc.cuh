// The tensor-core layer chain shared by K1 (mlp_fused_fwd.cu) and K2's
// recompute (mlp_fused_bwd.cu): both run the same code, so K2 sees the
// forward's activations bit for bit (and takes every ReLU the same way).
//
// Chains whose padded widths are at most 128 (the four field chains, the
// proposal chain): a warp runs a tile of 16 * kM rows through the chain on
// mma.sync m16n8k16 (bf16 operands, f32 sums; fragment layout in
// mma_bf16.cuh). The weights are staged once per block into shared memory
// as bf16 W^T[n][k], K padded to 16 and N to 8 (hidden widths to 16) by zero
// weights and zero biases, rows 16 bytes apart beyond K so that ldmatrix
// reads them without bank conflicts; the biases stay f32. x comes in by
// cp.async (stage_rows) and its A fragments are rounded from f32
// (x_fragments). The f32 accumulator fragment of one layer, after bias, ReLU
// and rounding to bf16x2, is exactly the A fragment of the next layer, so
// activations between layers stay in registers (chain_forward).
//
// Wider chains (up to 256, the DINO head's 15 -> 256 -> 128): a 256-wide
// activation as A fragments is 64 registers a thread, and the next layer's
// another 64. So the wide kernels keep each layer's bf16 input in shared
// memory instead, row-major at a row stride of K + 8 (stage_x_bf16 for x),
// and pairs_product reads one A fragment per k-tile by ldmatrix and feeds it
// to up to four n-tile pairs (64 output columns) at once: 32 f32 sums, a
// handful of other registers. Every output element is still the sum of the
// same mma k-tiles in the same order from zero, whichever pairs are grouped,
// so K2's recompute of a column slice has K1's bits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace umhs {

constexpr int kChainMaxLayers = 8;
constexpr int kChainMaxWidth = 128;                 // widest padded layer the chain holds
constexpr int kChainMaxPairs = kChainMaxWidth / 16;  // n-tile pairs of the widest output

struct TcChain {
  int num_layers;
  int d[kChainMaxLayers + 1];  // widths, unpadded
  int kt[kChainMaxLayers];     // 16-wide k-tiles of layer l's input
  int nt[kChainMaxLayers];     // 8-wide n-tiles of layer l's output
  int w_off[kChainMaxLayers];  // bf16 offset of layer l's W^T in shared memory
  int b_off[kChainMaxLayers];  // float offset of layer l's bias in the bias block
  int w_bytes;                 // bytes of all W^T, a multiple of 16
  int b_floats;                // floats of all biases, a multiple of 4
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// e * magic >> 20 == e / divisor for the small e the kernels divide.
inline uint32_t magic_for(int divisor) { return ((1u << 20) + divisor - 1) / divisor; }

__device__ __forceinline__ int fast_div(int e, uint32_t magic) {
  return static_cast<int>((static_cast<uint32_t>(e) * magic) >> 20);
}

// Fills `c` for the chain of widths d[0..num_layers]; false when a padded
// width exceeds max_width. The last layer's output is padded to last_pad
// (8, or 16 where every layer is read in n-tile pairs).
inline bool tc_chain(const int* d, int num_layers, TcChain& c,
                     int max_width = kChainMaxWidth, int last_pad = 8) {
  c = TcChain{};
  c.num_layers = num_layers;
  int w_elems = 0, b_floats = 0;
  for (int l = 0; l <= num_layers; ++l) c.d[l] = d[l];
  for (int l = 0; l < num_layers; ++l) {
    const int kp = round_up(d[l], 16);
    const int np = round_up(d[l + 1], l + 1 == num_layers ? last_pad : 16);
    if (kp > max_width || np > max_width) return false;
    c.kt[l] = kp / 16;
    c.nt[l] = np / 8;
    c.w_off[l] = w_elems;
    c.b_off[l] = b_floats;
    w_elems += np * (kp + 8);  // a multiple of 8 bf16: offsets stay 16-byte aligned
    b_floats += np;
  }
  c.w_bytes = round_up(2 * w_elems, 16);
  c.b_floats = round_up(b_floats, 4);
  return true;
}

// Stages W_l^T (bf16, zero-padded, row stride K + 8) and b_l (f32) of the
// first `layers` layers; the block's kThreads threads call it together.
// Global layout is unpadded [W0 (din x dout), b0, W1, b1, ...].
template <int kThreads>
__device__ __forceinline__ void stage_chain_weights(const TcChain& c, int layers,
                                                    const float* __restrict__ params,
                                                    __nv_bfloat16* wt, float* bias) {
  int goff = 0;
  for (int l = 0; l < layers; ++l) {
    const int din = c.d[l], dout = c.d[l + 1];
    const int stride = 16 * c.kt[l] + 8, rows = 8 * c.nt[l];
    __nv_bfloat16* w = wt + c.w_off[l];
#pragma unroll 8  // independent loads: keep several in flight
    for (int i = threadIdx.x; i < rows * stride; i += kThreads) {
      const int nn = i / stride, k = i - nn * stride;
      w[i] = __float2bfloat16_rn(nn < dout && k < din ? params[goff + k * dout + nn] : 0.f);
    }
    for (int i = threadIdx.x; i < rows; i += kThreads)
      bias[c.b_off[l] + i] = i < dout ? params[goff + din * dout + i] : 0.f;
    goff += din * dout + dout;
  }
}

// Starts the copy of the `rows_per_tile` rows (width d) of tile `tile` of
// src into `buf`, each row at a stride of s floats (zero past row n). s == d
// copies the rows as they lie; otherwise d is a multiple of 4 and row_magic
// divides by d / 4.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int n, int tile,
                                           int rows_per_tile, float* buf, int d, int s,
                                           uint32_t row_magic, int lane) {
  const int tile_floats = rows_per_tile * d;
  const int64_t base = static_cast<int64_t>(tile) * tile_floats;
  const int64_t left_in_src = static_cast<int64_t>(n) * d - base;
  const int valid = left_in_src < tile_floats ? static_cast<int>(left_in_src) : tile_floats;
  for (int c = lane; c < tile_floats / 4; c += 32) {
    const int left = valid - 4 * c;
    const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * left : 0);
    int dst = 4 * c;
    if (s != d) {
      const int r = fast_div(c, row_magic);
      dst = r * s + 4 * c - r * d;
    }
    cp_async16(buf + dst, bytes > 0 ? src + base + 4 * c : src, bytes);
  }
}

// Columns c and c + 1 (c even) of staged row r, zero past d.
__device__ __forceinline__ float2 x_pair(const float* xs, int stride, int d, int r, int c) {
  if ((stride & 1) == 0)  // d is even too, so c < d means c + 1 < d: one 8-byte load
    return c < d ? *reinterpret_cast<const float2*>(xs + r * stride + c) : make_float2(0.f, 0.f);
  return make_float2(c < d ? xs[r * stride + c] : 0.f, c + 1 < d ? xs[r * stride + c + 1] : 0.f);
}

// A fragments of the staged x tile (row stride `stride`, width d0, kts
// k-tiles), rounded to bf16; columns past d0 are zero.
template <int kKT, int kM>
__device__ __forceinline__ void x_fragments(uint32_t (&a)[kM][kKT][4], const float* xs,
                                            int stride, int d0, int kts, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
    for (int kt = 0; kt < kKT; ++kt) {
      if (kt < kts) {
        const int c = 16 * kt + 2 * tig, r = 16 * mi + gid;
        const float2 p0 = x_pair(xs, stride, d0, r, c);
        const float2 p1 = x_pair(xs, stride, d0, r + 8, c);
        const float2 p2 = x_pair(xs, stride, d0, r, c + 8);
        const float2 p3 = x_pair(xs, stride, d0, r + 8, c + 8);
        a[mi][kt][0] = pack_bf16x2(p0.x, p0.y);
        a[mi][kt][1] = pack_bf16x2(p1.x, p1.y);
        a[mi][kt][2] = pack_bf16x2(p2.x, p2.y);
        a[mi][kt][3] = pack_bf16x2(p3.x, p3.y);
      }
    }
  }
}

// Runs layers [0, layers) of the chain on a warp's tile. On entry `a` holds
// the A fragments of layer 0's input (kKT: 16-wide k-tiles the activations
// may span; kM: m16 tiles per warp, so each B fragment read from shared
// memory feeds kM products). After each hidden layer l, `a` holds layer
// l + 1's input (bias, ReLU, bf16) and hook.hidden(l + 1, a) is called. If
// the chain's last layer runs, each of its n-tile pairs j is handed, f32 and
// unbiased, to hook.output(j, two, c0, c1, b0, b1): columns 16j + 2tig (+1)
// in c0, 8 more in c1 (when `two`), with their biases b0 and b1.
template <int kKT, int kM, class Hook>
__device__ __forceinline__ void chain_forward(uint32_t (&a)[kM][kKT][4], const TcChain& c,
                                              const __nv_bfloat16* wt, const float* bias,
                                              int layers, int lane, Hook& hook) {
  const int tig = lane & 3;
  for (int l = 0; l < layers; ++l) {
    const bool last = l + 1 == c.num_layers;
    const int kts = c.kt[l], nts = c.nt[l];
    const int stride = 16 * kts + 8;
    const __nv_bfloat16* w = wt + c.w_off[l];
    const float* b = bias + c.b_off[l];
    uint32_t an[kM][kKT][4];
#pragma unroll
    for (int j = 0; j < kChainMaxPairs; ++j) {  // n-tiles 2j and 2j + 1
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
              ldmatrix_x4(bf, wrow + 16 * kt);
#pragma unroll
              for (int mi = 0; mi < kM; ++mi) {
                mma_bf16_16816(c0[mi], a[mi][kt], bf[0], bf[1]);
                mma_bf16_16816(c1[mi], a[mi][kt], bf[2], bf[3]);
              }
            } else {
              ldmatrix_x2(bf, wrow + 16 * kt);
#pragma unroll
              for (int mi = 0; mi < kM; ++mi) mma_bf16_16816(c0[mi], a[mi][kt], bf[0], bf[1]);
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
              an[mi][j][0] = pack_bf16x2(fmaxf(c0[mi][0] + b0.x, 0.f), fmaxf(c0[mi][1] + b0.y, 0.f));
              an[mi][j][1] = pack_bf16x2(fmaxf(c0[mi][2] + b0.x, 0.f), fmaxf(c0[mi][3] + b0.y, 0.f));
              an[mi][j][2] = pack_bf16x2(fmaxf(c1[mi][0] + b1.x, 0.f), fmaxf(c1[mi][1] + b1.y, 0.f));
              an[mi][j][3] = pack_bf16x2(fmaxf(c1[mi][2] + b1.x, 0.f), fmaxf(c1[mi][3] + b1.y, 0.f));
            }
          }
        } else {
          hook.output(j, two, c0, c1, b0, b1);
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
      hook.hidden(l + 1, a);
    }
  }
}

// ------------------------------------------------- chains wider than 128

constexpr int kWideMaxWidth = 256;  // widest padded layer the wide kernels take

// Rounds `rows` rows of x (width d, row-major), from row row0 on, to bf16
// into dst (row stride ds), zero past row n and from column d to kp; the
// warp's lanes call it together.
__device__ __forceinline__ void stage_x_bf16(const float* __restrict__ x, int n, int64_t row0,
                                             int rows, int d, int kp, __nv_bfloat16* dst,
                                             int ds, int lane) {
  for (int e = lane; e < rows * kp; e += 32) {
    const int r = e / kp, k = e - r * kp;
    const int64_t row = row0 + r;
    dst[r * ds + k] = __float2bfloat16_rn(row < n && k < d ? x[row * d + k] : 0.f);
  }
}

// Stages W_l^T (bf16, zero-padded, row stride K + 8) and b_l (f32) of every
// layer of `c`, reading params in their own order (coalesced) and writing
// the transpose; the block's threads call it together.
__device__ __forceinline__ void stage_wide_weights(const TcChain& c,
                                                   const float* __restrict__ params,
                                                   __nv_bfloat16* wt, float* bias) {
  const int tid = threadIdx.x, threads = blockDim.x;
  for (int i = tid; i < c.w_bytes / 16; i += threads)
    reinterpret_cast<uint4*>(wt)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  int goff = 0;
  for (int l = 0; l < c.num_layers; ++l) {
    const int din = c.d[l], dout = c.d[l + 1], stride = 16 * c.kt[l] + 8;
    __nv_bfloat16* w = wt + c.w_off[l];
    for (int e = tid; e < din * dout; e += threads) {
      const int k = e / dout, nn = e - k * dout;
      w[nn * stride + k] = __float2bfloat16_rn(params[goff + e]);
    }
    for (int i = tid; i < 8 * c.nt[l]; i += threads)
      bias[c.b_off[l] + i] = i < dout ? params[goff + din * dout + i] : 0.f;
    goff += din * dout + dout;
  }
}

// acc[p][h] = sum over k-tiles kt < kts of A(kt) . B(n-tile 2p + h, kt), for
// the n-tile pairs p < pairs (at most kP): A is a warp's 16 rows, bf16,
// row-major at row stride `as`; B is bf16 W^T[n][k] at row stride `ws`, from
// its first n-tile pair on. One ldmatrix of A per k-tile feeds every pair,
// and a k-tile's B fragments are all loaded before its first mma.
template <int kP>
__device__ __forceinline__ void pairs_product(float (&acc)[kP][2][4], const __nv_bfloat16* a,
                                              int as, const __nv_bfloat16* w, int ws, int pairs,
                                              int kts, int lane) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][h][q] = 0.f;
  // ldmatrix rows: A's matrix lane / 8 is rows 8 ((lane / 8) % 2) on, k half
  // lane / 16; B's is n-tile 2p + lane / 16, k half (lane / 8) % 2
  const __nv_bfloat16* arow = a + (lane & 15) * as + 8 * (lane >> 4);
  const __nv_bfloat16* wrow = w + (8 * (lane >> 4) + (lane & 7)) * ws + 8 * ((lane >> 3) & 1);
  for (int kt = 0; kt < kts; ++kt) {
    uint32_t af[4], bf[kP][4];
    ldmatrix_x4(af, arow + 16 * kt);
#pragma unroll
    for (int p = 0; p < kP; ++p)
      if (p < pairs) ldmatrix_x4(bf[p], wrow + 16 * p * ws + 16 * kt);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p < pairs) {
        mma_bf16_16816(acc[p][0], af, bf[p][0], bf[p][1]);
        mma_bf16_16816(acc[p][1], af, bf[p][2], bf[p][3]);
      }
    }
  }
}

}  // namespace umhs
