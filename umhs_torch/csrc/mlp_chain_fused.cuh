// The fused route of K1 (mlp_fused_fwd.cu) and K2 (mlp_fused_bwd.cu): a whole
// bf16 chain in one launch for every chain the general route would otherwise
// take whose hidden widths, padded to 16, are at most 256 (config C's
// mlp_base 280 -> 64 -> 16 and mlp_directional 28 -> 16 -> 281, 9 and 16
// layers of 64), with the input and output at most kMaxEnd wide, at most
// kMaxLayers layers, and both kernels' tiles within a block's shared memory
// (chain_fits). Other chains keep the general route (64 -> 256 -> 256 -> 256
// and 28 -> 256 -> 257 among them: their K2 tiles would pass it).
//
// This is the Pallas kernel's own design (umhs_tpu/ops/pallas/mlp_fused.py:
// _fwd_kernel and _bwd_kernel: x read once, y written once, the hidden
// activations never in device memory). A block of 16 warps walks tiles of
// 64 rows:
// - x's tile, a contiguous span of 64 x d_0 floats, comes in by one flat
//   cp.async into an f32 stage, the next tile's while this one is worked on
//   (where the weights are resident, below): K1 keeps two stages and reads
//   layer 0's A fragments from them, rounding to bf16 as it reads; K2 rounds
//   x into shared memory at the tile's start (its dW_0 reads it again);
// - each layer's product runs on the tensor cores (mma.sync m16n8k16, f32
//   sums) from shared memory: the layer input is resident; the weights too
//   where all of them fit beside the kernel's tiles (config C's both chains,
//   9 layers of 64; K1 at 16 of them: staged once a block, W_l
//   [pad16(d_l)][pad16(d_l+1) + 8], read as [k][n] by the
//   forward and as W^T by K2's products), else streamed through a two-slice
//   ring of 32 k-rows; a product runs in passes of 64 columns, the 16 warps
//   splitting each 4 x 4 into row tiles and n-tile pairs, each warp's sums
//   in 8 registers, so that 16 warps an SM hide each other's latencies
//   within 128 registers (K2's owned dW sums among them). The same
//   products on wgmma m64n16k16 (a warpgroup taking the tile's 64 rows and
//   16 columns of a pass from operands tiled as wgmma's core matrices, x
//   rounded into shared memory by one pass) gave the same bits and lost in
//   turns on an H100: K1 5-14% slower on every chain of
//   the route, K2 6-8% faster on config C's two chains but 5-8% slower on
//   9 and 16 layers of 64, config C's traced K1 + K2 2.41 against 2.37 ms:
//   at one 64-row tile a block each pass waits on its wgmma group, where
//   the 16 warps' mma.sync products overlap;
// - bias, ReLU and the bf16 rounding happen at K1's rounding points in the
//   epilogue, which writes the next layer's input into shared memory;
// - the last layer's f32 outputs go to y straight from the fragments where
//   d_L % 8 == 0 (a warp's store then fills eight whole 32-byte sectors);
//   else they are staged in shared memory at y's own row stride, so the
//   tile's rows are one contiguous span of rows x d_L floats, 16-byte
//   aligned (the tile starts at a multiple of 64 rows), stored 16 bytes at a
//   time (a 2-D TMA map cannot describe y at 281 columns: its 1,124-byte row
//   stride is not a multiple of 16).
// The ragged last tile reads and stores only its own rows.
//
// K2, one launch per fixed range of tiles (a block's range depends on the
// chain and the row count only: kSplitTarget blocks at most):
// - the recompute is K1's product code on the same tiles in the same k order
//   from zero, so every activation and every ReLU decision is K1's; each
//   layer's input stays in shared memory;
// - g's tile comes in once (prefetched as x's, into its own f32 stage); its
//   column sums (db of the last layer, f32, rows in order) are taken there
//   and it is rounded to bf16 as the first dh;
// - each layer, from the last: dW_l = a_l^T . dh_l over the tile's 64 rows
//   (both operands by ldmatrix.trans) added to the block's own partial sums
//   in device memory (read, add, write by the same thread every tile: no
//   atomics), then dh_{l-1} = (dh_l . W_l^T) where a_l > 0, rounded to bf16
//   for the next products, its f32 column sums db_{l-1} taken in registers;
// - dx = dh_0 . W_0^T, stored as K1 stores y, only when it is wanted (dW and
//   db do not depend on it).
// mlp_sum_rows_kernel then adds the blocks' partial sums in block order. A
// run repeats bit for bit.
//
// What bounds it on an H100: the chains it exists for move 100-1,200 bytes a
// row against 1-300 thousand multiply-adds, so at config C's widths it is
// bound by bytes (x and y once: 0.093-0.097 ms at 262,144 rows; K2 x, g and
// dx once) and deep chains by operations. The design keeps every byte of x,
// g, y and dx to one pass and off the critical path (prefetch, whole-sector
// or 16-byte stores) and the activations on the chip.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "mlp_general.cuh"
#include "mma_bf16.cuh"

namespace umhs {
namespace chain {

constexpr int kRows = 64;        // rows a tile: 4 m16 tiles
constexpr int kWarps = 16;       // 4 down the row tiles x 4 across the n-tile pairs
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 32;       // k-rows of one weight slice in the ring
constexpr int kMaxN = 64;        // output columns of one pass of a product: a pair a warp
constexpr int kMaxHidden = 256;  // the route's padded hidden widths
constexpr int kMaxEnd = 320;     // the route's input and output widths
constexpr int kMaxLayers = 64;
constexpr int kSkew = 8;         // bf16 past each staged row: ldmatrix rows on distinct banks
constexpr int kOwnMax = 10;  // K2: dW tiles a warp keeps in registers across its block's rows

__host__ __device__ inline int pad16(int w) { return (w + 15) / 16 * 16; }
__host__ __device__ inline int al16(int b) { return (b + 15) / 16 * 16; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
// Whether a width's f32 rows are stored straight from the fragments: a
// multiple of 8 floats, so each n-tile's 32 bytes of a row are one sector.
__host__ __device__ inline bool direct_rows(int w) { return w % 8 == 0; }

// The chain, by value: widths and the packed weights' places in the scratch
// (general::pack_weights' layout: W_l bf16 [pad16(d_l)][pad16(d_l+1)], b_l
// f32 pad16(d_l+1), zeros around), the params layout's offsets, and the
// shared-memory places that need a table.
struct Chain {
  int L;
  int d[kMaxLayers + 1];
  int64_t w_off[kMaxLayers];  // bytes from the scratch's start
  int64_t b_off[kMaxLayers];
  int64_t p_off[kMaxLayers];  // floats: W_l in [W0, b0, W1, b1, ...]; b_l at + d_l * d_l+1
  int64_t p_count;            // floats of the params layout
  int a_off[kMaxLayers];      // K2: bytes of layer l's input a_l in shared memory (bwd_smem)
  int ws_off[kMaxLayers];     // resident W_l, bytes from the weights' region
  int ws_bytes;               // the resident weights' bytes
  int res_fwd, res_bwd;       // whether they fit beside K1's / K2's tiles (else the ring)
  int t_off[kMaxLayers + 1];  // K2: the first m16n8 dW tile of layer l, in (l, m, n) order
  int own;                    // K2: whether each warp owns its dW tiles (kOwnMax each at most)
};

// Widest padded hidden width (0 for one layer).
__host__ __device__ inline int widest_hidden(const Chain& c) {
  int w = 0;
  for (int l = 1; l < c.L; ++l) w = imax(w, pad16(c.d[l]));
  return w;
}

// The ring's elements a slice: the forward's [k][n] slices, K2's [n][k] too.
__host__ __device__ inline int ring_elems(const Chain& c, bool bwd) {
  int fwd = 16, back = 16;
  for (int l = 0; l < c.L; ++l) {
    if (!bwd || l + 1 < c.L) fwd = imax(fwd, imin(kMaxN, pad16(c.d[l + 1])));
    back = imax(back, imin(kMaxN, pad16(c.d[l])));
  }
  return bwd ? imax(kSlice * (fwd + kSkew), back * (kSlice + kSkew)) : kSlice * (fwd + kSkew);
}

// Shared-memory carves, in bytes from the dynamic buffer's start, the same on
// the host (sizes) and the device (pointers). K1: two f32 stages of x (one
// tile's read while the next one's lands; layer 0 reads x from them), two
// hidden buffers, the ring or the resident weights, y's stage (where y is
// staged).
struct FwdSmem {
  int xs, xs1, h0, h1, ring, w, ys, bytes;
  int h_ld, ring_elems;
};

__host__ __device__ inline FwdSmem fwd_smem(const Chain& c) {
  FwdSmem s{};
  const int d0 = c.d[0], dl = c.d[c.L];
  s.h_ld = widest_hidden(c) + kSkew;
  s.ring_elems = c.res_fwd ? 0 : ring_elems(c, false);
  int at = 0;
  s.xs = at;
  at += al16(4 * kRows * d0);
  s.xs1 = at;
  at += al16(4 * kRows * d0);
  s.h0 = at;
  if (c.L > 1) at += al16(2 * kRows * s.h_ld);
  s.h1 = at;
  if (c.L > 2) at += al16(2 * kRows * s.h_ld);
  s.ring = at;
  at += 2 * al16(2 * s.ring_elems);
  s.w = at;
  if (c.res_fwd) at += c.ws_bytes;
  s.ys = at;
  if (!direct_rows(dl)) at += al16(4 * kRows * dl);
  s.bytes = at;
  return s;
}

// K2: every layer's input a_l (bf16 [64][pad16(d_l) + kSkew], at a_off[l]
// when `a_off` is given), x's and g's f32 stages, the two dh buffers, the
// ring or the resident weights, and an f32 stage for each hidden dh's row
// tiles' column sums and for dx (where dx is staged).
struct BwdSmem {
  int xs, gs, dh[2], ring, w, rs, bytes;
  int dh_ld[2], ring_elems;
};

__host__ __device__ inline BwdSmem bwd_smem(const Chain& c, int* a_off = nullptr) {
  BwdSmem s{};
  const int d0 = c.d[0], dl = c.d[c.L];
  int at = 0;
  for (int l = 0; l < c.L; ++l) {
    if (a_off) a_off[l] = at;
    at += al16(2 * kRows * (pad16(c.d[l]) + kSkew));
  }
  s.xs = at;
  at += al16(4 * kRows * d0);
  s.gs = at;
  at += al16(4 * kRows * dl);
  // dh of layer l's output (width d_l+1) lives in buffer (L - 1 - l) & 1
  s.dh_ld[0] = s.dh_ld[1] = 0;
  for (int l = 0; l < c.L; ++l) {
    const int b = (c.L - 1 - l) & 1;
    s.dh_ld[b] = imax(s.dh_ld[b], pad16(c.d[l + 1]) + kSkew);
  }
  for (int b = 0; b < 2; ++b) {
    s.dh[b] = at;
    at += al16(2 * kRows * s.dh_ld[b]);
  }
  s.ring_elems = c.res_bwd ? 0 : ring_elems(c, true);
  s.ring = at;
  at += 2 * al16(2 * s.ring_elems);
  s.w = at;
  if (c.res_bwd) at += c.ws_bytes;
  s.rs = at;
  at += al16(4 * imax(4 * widest_hidden(c), direct_rows(d0) ? 0 : kRows * d0));
  s.bytes = at;
  return s;
}

// The chain for the launchers and for chain_fits: widths, the packed
// weights' offsets from the scratch's start (general::pack_weights' carve),
// the resident weights' layout and whether they are resident.
inline Chain make_chain(const int* d, int L) {
  Chain c{};
  c.L = L;
  for (int l = 0; l <= L; ++l) c.d[l] = d[l];
  int64_t at = 0, p = 0;
  int ws = 0;
  for (int l = 0; l < L; ++l) {
    c.w_off[l] = at;
    at += general::al256(static_cast<size_t>(pad16(d[l])) * pad16(d[l + 1]) * 2);
    c.b_off[l] = at;
    at += general::al256(sizeof(float) * pad16(d[l + 1]));
    c.p_off[l] = p;
    p += int64_t{d[l]} * d[l + 1] + d[l + 1];
    c.ws_off[l] = ws;
    ws += al16(2 * pad16(d[l]) * (pad16(d[l + 1]) + kSkew));
  }
  c.p_count = p;
  c.ws_bytes = ws;
  c.res_fwd = c.res_bwd = 1;
  c.res_fwd = fwd_smem(c).bytes <= kFusedSmemLimit;
  c.res_bwd = bwd_smem(c).bytes <= kFusedSmemLimit;
  c.t_off[0] = 0;
  for (int l = 0; l < L; ++l) c.t_off[l + 1] = c.t_off[l] + pad16(d[l]) / 16 * (pad16(d[l + 1]) / 8);
  c.own = c.t_off[L] <= kWarps * kOwnMax;
  bwd_smem(c, c.a_off);
  return c;
}

// Whether the fused route takes the chain d[0..L] (bf16).
inline bool chain_fits(const int* d, int L) {
  if (L < 1 || L > kMaxLayers || d[0] > kMaxEnd || d[L] > kMaxEnd) return false;
  for (int l = 1; l < L; ++l)
    if (pad16(d[l]) > kMaxHidden) return false;
  const Chain c = make_chain(d, L);
  return fwd_smem(c).bytes <= kFusedSmemLimit && bwd_smem(c).bytes <= kFusedSmemLimit;
}

// ------------------------------------------------------------- the products

// How the 16 warps split a (16 * mtiles) x (16 * pairs) output, mtiles <= 4
// and pairs <= 4: warp w takes row tile w / 4 (none past mtiles) and n-tile
// pair w % 4 (none past pairs).
struct Split {
  int mt, has_mt, p0, pn;
};

__device__ __forceinline__ Split split_for(int pairs, int mtiles = 4) {
  const int warp = threadIdx.x >> 5;
  Split s;
  s.mt = warp >> 2;
  s.has_mt = s.mt < mtiles;
  s.p0 = warp & 3;
  s.pn = s.p0 < pairs ? (pairs - s.p0 + 3) / 4 : 0;
  return s;
}

// Sums of one warp: its row tile's n-tiles 2p, 2p + 1 (p = p0) at v[h].
struct Acc {
  float v[2][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = 0.f;
  }
};

// A fragment of row tile mt at k: A[m][k] at s[m * ld + k] (k contiguous).
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], const __nv_bfloat16* s, int ld, int mt,
                                       int k, int lane) {
  ldmatrix_x4(a, s + (16 * mt + (lane & 15)) * ld + k + 8 * (lane >> 4));
}

// A fragment of row tile mt at k: A[m][k] at s[k * ld + m] (m contiguous).
__device__ __forceinline__ void a_cols(uint32_t (&a)[4], const __nv_bfloat16* s, int ld, int mt,
                                       int k, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(a, s + (k + r + 8 * (q >> 1)) * ld + 16 * mt + 8 * (q & 1));
}

// A fragment of row tile mt at k from f32 rows (A[m][k] at s[m * ld + k],
// zeros from column w on), rounded to bf16 as it is read: the values of the
// bf16 copy that a_rows would read.
__device__ __forceinline__ uint32_t f32_pair(const float* row, int c, int w) {
  if ((w & 1) == 0) {
    if (c >= w) return 0u;
    const float2 v = *reinterpret_cast<const float2*>(row + c);
    return pack_bf16x2(v.x, v.y);
  }
  return pack_bf16x2(c < w ? row[c] : 0.f, c + 1 < w ? row[c + 1] : 0.f);
}

__device__ __forceinline__ void a_rows_f32(uint32_t (&a)[4], const float* s, int ld, int w, int mt,
                                           int k, int lane) {
  const int gid = lane >> 2, c = k + 2 * (lane & 3);
  const float* r0 = s + (16 * mt + gid) * ld;
  const float* r1 = r0 + 8 * ld;
  a[0] = f32_pair(r0, c, w);
  a[1] = f32_pair(r1, c, w);
  a[2] = f32_pair(r0, c + 8, w);
  a[3] = f32_pair(r1, c + 8, w);
}

// B fragments of n-tiles 2p, 2p + 1 at k: B[k][n] at s[k * ld + n].
__device__ __forceinline__ void b_kn(uint32_t (&b)[4], const __nv_bfloat16* s, int ld, int p,
                                     int k, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldmatrix_x4_trans(b, s + (k + 8 * (q & 1) + r) * ld + 16 * p + 8 * (q >> 1));
}

// B fragments of n-tiles 2p, 2p + 1 at k: B[k][n] at s[n * ld + k].
__device__ __forceinline__ void b_nk(uint32_t (&b)[4], const __nv_bfloat16* s, int ld, int p,
                                     int k, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldmatrix_x4(b, s + (16 * p + 8 * (q >> 1) + r) * ld + k + 8 * (q & 1));
}

// How a product reads A: rows of bf16 (k contiguous), columns of bf16 (the
// dW product's a^T), or rows of f32 rounded as read (K1's x).
enum AMode : int { kARows = 0, kACols = 1, kARowsF32 = 2 };

// One k16 step of the warp's products: its row tile's A fragment, then per
// n-tile pair the B fragments and two mma. aw: kARowsF32's valid columns.
template <int kA, bool kBT>
__device__ __forceinline__ void k_step(Acc& acc, const Split& sp, const void* a, int lda, int aw,
                                       int ka, const __nv_bfloat16* b, int ldb, int kb,
                                       int lane) {
  if (!sp.has_mt || sp.pn == 0) return;
  uint32_t af[4];
  if (kA == kACols)
    a_cols(af, static_cast<const __nv_bfloat16*>(a), lda, sp.mt, ka, lane);
  else if (kA == kARows)
    a_rows(af, static_cast<const __nv_bfloat16*>(a), lda, sp.mt, ka, lane);
  else
    a_rows_f32(af, static_cast<const float*>(a), lda, aw, sp.mt, ka, lane);
#pragma unroll
  for (int j = 0; j < 1; ++j)
    if (j < sp.pn) {
      uint32_t bf[4];
      if (kBT)
        b_kn(bf, b, ldb, sp.p0 + 4 * j, kb, lane);
      else
        b_nk(bf, b, ldb, sp.p0 + 4 * j, kb, lane);
      mma_bf16_16816(acc.v[2 * j], af, bf[0], bf[1]);
      mma_bf16_16816(acc.v[2 * j + 1], af, bf[2], bf[3]);
    }
}

// Hands each pair of sums to epi(row, col, v0, v1): (row, col) and (row,
// col + 1) of the output, col even.
template <typename Epi>
__device__ __forceinline__ void each_pair(const Acc& acc, const Split& sp, int lane, Epi&& epi) {
  if (!sp.has_mt) return;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 1; ++j)
    if (j < sp.pn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * sp.mt + gid;
        const int col = 16 * (sp.p0 + 4 * j) + 8 * h + 2 * tig;
        const float* v = acc.v[2 * j + h];
        epi(row, col, v[0], v[1]);
        epi(row + 8, col, v[2], v[3]);
      }
}

// Where a product's B (the layer's weights) comes from: resident in shared
// memory (res, [pad16(d_l)][pad16(d_l+1) + kSkew]), or streamed from the
// packed weights in device memory (w, row stride ldw) through the ring.
struct Weights {
  const __nv_bfloat16* res;
  int res_ld;
  const __nv_bfloat16* w;
  int ldw;
  __nv_bfloat16* ring;
  int ring_elems;
};

// out (64 x nc) = A (64 x K, resident, k contiguous) . B, K a multiple of
// 16: kWkn, B[k][n] = W_l[k][n0 + n] (the forward); else B[k][n] =
// W_l[n0 + n][k] (K2's dh and dx products: B = W_l^T). Then epi on every
// pair of sums.
template <bool kWkn, int kA = kARows, typename Epi>
__device__ void product(const void* a, int lda, int aw, const Weights& wt, int K, int n0, int nc,
                        Epi&& epi) {
  const int lane = threadIdx.x & 31;
  const Split sp = split_for(nc / 16);
  Acc acc;
  acc.zero();
  if (wt.res != nullptr) {
    const __nv_bfloat16* b = kWkn ? wt.res + n0 : wt.res + n0 * wt.res_ld;
    for (int k = 0; k < K; k += 16)
      k_step<kA, kWkn>(acc, sp, a, lda, aw, k, b, wt.res_ld, k, lane);
  } else {
    const int ldr = kWkn ? nc + kSkew : kSlice + kSkew;
    const int slices = (K + kSlice - 1) / kSlice;
    auto stage = [&](int buf, int k0) {
      __nv_bfloat16* s = wt.ring + buf * wt.ring_elems;
      if (kWkn) {  // slice rows k0.., each nc wide
        const int per = nc / 8;
        for (int c = threadIdx.x; c < kSlice * per; c += kThreads) {
          const int r = c / per, e = (c - r * per) * 8;
          const bool in = k0 + r < K;
          cp_async16(s + r * ldr + e,
                     in ? wt.w + static_cast<int64_t>(k0 + r) * wt.ldw + n0 + e : wt.w,
                     in ? 16 : 0);
        }
      } else {  // nc rows of W, k0.. of each
        constexpr int per = kSlice / 8;
        for (int c = threadIdx.x; c < nc * per; c += kThreads) {
          const int r = c / per, e = (c - r * per) * 8;
          const bool in = k0 + e < K;
          cp_async16(s + r * ldr + e,
                     in ? wt.w + static_cast<int64_t>(n0 + r) * wt.ldw + k0 + e : wt.w,
                     in ? 16 : 0);
        }
      }
    };
    stage(0, 0);
    cp_async_commit();
    for (int s = 0; s < slices; ++s) {
      if (s + 1 < slices) stage((s + 1) & 1, (s + 1) * kSlice);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const __nv_bfloat16* b = wt.ring + (s & 1) * wt.ring_elems;
      const int kts = min(kSlice, K - s * kSlice) / 16;
      for (int kt = 0; kt < kts; ++kt)
        k_step<kA, kWkn>(acc, sp, a, lda, aw, s * kSlice + 16 * kt, b, ldr, 16 * kt, lane);
      __syncthreads();
    }
    cp_async_wait<0>();
  }
  each_pair(acc, sp, lane, epi);
}

// out (16 * mtiles x nc) = A^T . B over the tile's 64 rows, both resident
// with rows as k: A[m][k] = a[k * lda + m0 + m], B[k][n] = b[k * ldb + n0 +
// n] (the dW product where the warps cannot own the sums). Then epi on
// every pair of sums.
template <typename Epi>
__device__ void rows_product(const __nv_bfloat16* a, int lda, int m0, int mtiles,
                             const __nv_bfloat16* b, int ldb, int n0, int nc, Epi&& epi) {
  const int lane = threadIdx.x & 31;
  const Split sp = split_for(nc / 16, mtiles);
  Acc acc;
  acc.zero();
#pragma unroll
  for (int kt = 0; kt < kRows / 16; ++kt)
    k_step<kACols, true>(acc, sp, a + m0, lda, 0, 16 * kt, b + n0, ldb, 16 * kt, lane);
  each_pair(acc, sp, lane, epi);
}

// The dW sums a warp owns across the block's tiles: the chain's m16n8 dW
// tiles in (layer, m-tile, n-tile) order, warp w owning tiles w, w + 16,
// w + 32, ... (Chain::own), each tile's sums in registers from the block's
// first row to its last, so no partial sum leaves the chip before the block
// ends.
struct Owned {
  float v[kOwnMax][4];
  int w, count;  // the warp, and how many tiles it owns
};

// Adds a_l^T . dh_l over the tile's 64 rows to the warp's owned tiles of
// layer l (A by ldmatrix.trans from a_l, B, one n-tile, from dh_l).
__device__ __forceinline__ void owned_product(Owned& o, const Chain& c, int l,
                                              const __nv_bfloat16* a, int lda,
                                              const __nv_bfloat16* dh, int ldd, int lane) {
  const int nt = pad16(c.d[l + 1]) / 8, lo = c.t_off[l], hi = c.t_off[l + 1];
#pragma unroll
  for (int q = 0; q < kOwnMax; ++q) {
    const int t = o.w + kWarps * q;
    if (q < o.count && t >= lo && t < hi) {
      const int mi = (t - lo) / nt, ni = (t - lo) - mi * nt;
#pragma unroll
      for (int kt = 0; kt < kRows / 16; ++kt) {
        uint32_t af[4], bf[2];
        a_cols(af, a, lda, mi, 16 * kt, lane);
        ldmatrix_x2_trans(bf, dh + (16 * kt + (lane & 15)) * ldd + 8 * ni);
        mma_bf16_16816(o.v[q], af, bf[0], bf[1]);
      }
    }
  }
}

// The owned sums into the block's partials (the params layout).
__device__ __forceinline__ void owned_store(const Owned& o, const Chain& c, float* part,
                                            int lane) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int q = 0; q < kOwnMax; ++q) {
    if (q >= o.count) break;
    const int t = o.w + kWarps * q;
    int l = 0;
    while (t >= c.t_off[l + 1]) ++l;
    const int din = c.d[l], dout = c.d[l + 1], nt = pad16(dout) / 8;
    const int mi = (t - c.t_off[l]) / nt, ni = (t - c.t_off[l]) - mi * nt;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * mi + gid + 8 * (e >> 1), j = 8 * ni + 2 * tig + (e & 1);
      if (i < din && j < dout) part[c.p_off[l] + int64_t{i} * dout + j] = o.v[q][e];
    }
  }
}

// Layer l's weights for the products: resident (the region at `wsm`) or
// through the ring.
__device__ __forceinline__ Weights layer_weights(const Chain& c, bool resident,
                                                 const char* packed, const unsigned char* wsm,
                                                 int l, __nv_bfloat16* ring, int ring_elems) {
  Weights wt;
  wt.res = resident ? reinterpret_cast<const __nv_bfloat16*>(wsm + c.ws_off[l]) : nullptr;
  wt.res_ld = pad16(c.d[l + 1]) + kSkew;
  wt.w = reinterpret_cast<const __nv_bfloat16*>(packed + c.w_off[l]);
  wt.ldw = pad16(c.d[l + 1]);
  wt.ring = ring;
  wt.ring_elems = ring_elems;
  return wt;
}

// Every layer's packed W_l into the resident region, by cp.async (not
// committed).
__device__ __forceinline__ void stage_weights(const Chain& c, const char* packed,
                                              unsigned char* wsm) {
  for (int l = 0; l < c.L; ++l) {
    const int rows = pad16(c.d[l]), np = pad16(c.d[l + 1]), per = np / 8;
    const auto* w = reinterpret_cast<const __nv_bfloat16*>(packed + c.w_off[l]);
    auto* s = reinterpret_cast<__nv_bfloat16*>(wsm + c.ws_off[l]);
    for (int e = threadIdx.x; e < rows * per; e += kThreads) {
      const int r = e / per, col = (e - r * per) * 8;
      cp_async16(s + r * (np + kSkew) + col, w + r * np + col, 16);
    }
  }
}

// The forward of layer l over the tile: relu(in . W_l + b_l) rounded to
// bf16 into h [64][ldo] (a hidden layer), or in . W_l + b_l in f32 to the
// rows of y (the last layer): straight to y (row stride d_L, `rows` rows)
// where direct_rows(d_L), else into ys at row stride d_L. `in`: bf16 rows,
// or (kInF32) f32 rows of d_l values (K1's x), rounded as they are read.
// K1 and K2's recompute run this same code: the same bf16 inputs, the same
// products in the same k order.
template <bool kInF32>
__device__ __forceinline__ void layer_forward(const Chain& c, const char* packed, int l,
                                              const Weights& wt, const void* in, int ldi,
                                              __nv_bfloat16* h, int ldo, float* y, int rows) {
  constexpr int kA = kInF32 ? kARowsF32 : kARows;
  const int dout = c.d[l + 1], np = pad16(dout), K = pad16(c.d[l]), aw = c.d[l];
  const auto* bias = reinterpret_cast<const float*>(packed + c.b_off[l]);
  const bool last = l + 1 == c.L, direct = direct_rows(dout);
  for (int n0 = 0; n0 < np; n0 += kMaxN) {
    const int nc = min(kMaxN, np - n0);
    if (!last) {
      product<true, kA>(in, ldi, aw, wt, K, n0, nc, [&](int r, int col, float v0, float v1) {
        const int n = n0 + col;
        *reinterpret_cast<uint32_t*>(h + r * ldo + n) =
            pack_bf16x2(fmaxf(v0 + bias[n], 0.f), fmaxf(v1 + bias[n + 1], 0.f));
      });
    } else {
      product<true, kA>(in, ldi, aw, wt, K, n0, nc, [&](int r, int col, float v0, float v1) {
        const int n = n0 + col;
        if (direct) {
          if (r < rows && n < dout)
            *reinterpret_cast<float2*>(y + static_cast<int64_t>(r) * dout + n) =
                make_float2(v0 + bias[n], v1 + bias[n + 1]);
        } else {
          if (n < dout) y[r * dout + n] = v0 + bias[n];
          if (n + 1 < dout) y[r * dout + n + 1] = v1 + bias[n + 1];
        }
      });
    }
  }
}

// count floats (a tile's contiguous span, 16-byte aligned) from src into
// an f32 stage by cp.async, 16 bytes a copy, the last piece partial; not
// committed.
__device__ __forceinline__ void stage_span(const float* src, int count, float* dst) {
  const int pieces = (count + 3) >> 2;
  for (int p = threadIdx.x; p < pieces; p += kThreads) {
    const int bytes = min(16, 4 * (count - 4 * p));
    cp_async16(dst + 4 * p, src + 4 * p, bytes);
  }
}

// The f32 stage ([rows][w], row stride w) into bf16 [64][ld], zeros past w
// up to pad16(w) and in rows past `rows`; two columns a step.
__device__ __forceinline__ void stage_to_bf16(const float* rs, int rows, int w, __nv_bfloat16* dst,
                                              int ld) {
  const int half = pad16(w) / 2;
  for (int e = threadIdx.x; e < kRows * half; e += kThreads) {
    const int r = e / half, col = 2 * (e - r * half);
    const float v0 = r < rows && col < w ? rs[r * w + col] : 0.f;
    const float v1 = r < rows && col + 1 < w ? rs[r * w + col + 1] : 0.f;
    *reinterpret_cast<uint32_t*>(dst + r * ld + col) = pack_bf16x2(v0, v1);
  }
}

// count floats of an f32 stage to dst (16-byte aligned), 16 bytes a store.
__device__ __forceinline__ void store_span(const float* rs, int count, float* __restrict__ dst) {
  const int n4 = count >> 2;
  for (int i = threadIdx.x; i < n4; i += kThreads)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(rs)[i];
  for (int e = 4 * n4 + threadIdx.x; e < count; e += kThreads) dst[e] = rs[e];
}

__device__ __forceinline__ int tile_rows(int n, int64_t r0) {
  return n - r0 < kRows ? static_cast<int>(n - r0) : kRows;
}

// ------------------------------------------------------------------ kernels

__global__ void __launch_bounds__(kThreads, 1)
mlp_chain_fwd_kernel(const float* __restrict__ x, const char* __restrict__ packed,
                     float* __restrict__ y, int n, const Chain c) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const FwdSmem s = fwd_smem(c);
  float* xs[2] = {reinterpret_cast<float*>(chain_smem + s.xs),
                  reinterpret_cast<float*>(chain_smem + s.xs1)};
  __nv_bfloat16* hs[2] = {reinterpret_cast<__nv_bfloat16*>(chain_smem + s.h0),
                          reinterpret_cast<__nv_bfloat16*>(chain_smem + s.h1)};
  auto* ring = reinterpret_cast<__nv_bfloat16*>(chain_smem + s.ring);
  auto* ys = reinterpret_cast<float*>(chain_smem + s.ys);
  const int d0 = c.d[0], dl = c.d[c.L];
  const bool staged_y = !direct_rows(dl);
  const int tiles = (n + kRows - 1) / kRows;
  auto fetch = [&](int tile, float* dst) {  // x's tile into a stage
    if (tile < tiles) {
      const int64_t r = static_cast<int64_t>(tile) * kRows;
      stage_span(x + r * d0, tile_rows(n, r) * d0, dst);
    }
    cp_async_commit();
  };
  if (c.res_fwd) stage_weights(c, packed, chain_smem + s.w);
  fetch(blockIdx.x, xs[0]);
  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int64_t r0 = static_cast<int64_t>(tile) * kRows;
    const int rows = tile_rows(n, r0);
    cp_async_wait<0>();
    __syncthreads();  // x's tile (and the weights) have landed; the other stage is free
    // the next tile's x while this one's is worked on, where no ring's waits
    // would wait for it too
    if (c.res_fwd) fetch(tile + gridDim.x, xs[(it + 1) & 1]);
    for (int l = 0; l < c.L; ++l) {
      const Weights wt =
          layer_weights(c, c.res_fwd, packed, chain_smem + s.w, l, ring, s.ring_elems);
      float* out = staged_y ? ys : y + r0 * dl;
      if (l == 0)
        layer_forward<true>(c, packed, 0, wt, xs[it & 1], d0, hs[0], s.h_ld, out, rows);
      else
        layer_forward<false>(c, packed, l, wt, hs[(l - 1) & 1], s.h_ld, hs[l & 1], s.h_ld, out,
                             rows);
      __syncthreads();
    }
    if (!c.res_fwd) fetch(tile + gridDim.x, xs[(it + 1) & 1]);
    if (staged_y) {
      store_span(ys, rows * dl, y + r0 * dl);
      __syncthreads();
    }
  }
}

// The block's partial sums: v into p[i] on the block's first tile, else
// added to it (the same thread owns p[i] on every tile).
__device__ __forceinline__ void add_partial(float* p, int64_t i, float v, bool first) {
  p[i] = first ? v : p[i] + v;
}

// Column sums over the tile's rows of an f32 stage (w columns at row stride
// ld) into the partial sums at p + col, in a fixed order: four running sums
// of the rows by row mod 4, then added pairwise.
__device__ __forceinline__ void column_sums(const float* rs, int rows, int w, int ld, float* p,
                                            bool first) {
  for (int col = threadIdx.x; col < w; col += kThreads) {
    // rows r % 4 == q summed in order into t[q], then (t0 + t1) + (t2 + t3)
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    int r = 0;
    for (; r + 4 <= rows; r += 4)
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] += rs[(r + q) * ld + col];
    for (int q = 0; r < rows; ++r, ++q) t[q] += rs[r * ld + col];
    add_partial(p, col, (t[0] + t[1]) + (t[2] + t[3]), first);
  }
}

// kOwn: the warps own the dW sums (Chain::own); else they go to the partials
// in device memory every tile. Two instances, so that each keeps to 128
// registers: the owned sums' 40 are not live in the other.
template <bool kOwn>
__global__ void __launch_bounds__(kThreads, 1)
mlp_chain_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     const char* __restrict__ packed, float* __restrict__ dx,
                     float* __restrict__ partials, int n, const Chain c) {
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const BwdSmem s = bwd_smem(c);
  auto* ring = reinterpret_cast<__nv_bfloat16*>(chain_smem + s.ring);
  auto* xs = reinterpret_cast<float*>(chain_smem + s.xs);
  auto* gs = reinterpret_cast<float*>(chain_smem + s.gs);
  auto* rs = reinterpret_cast<float*>(chain_smem + s.rs);
  auto act = [&](int l) { return reinterpret_cast<__nv_bfloat16*>(chain_smem + c.a_off[l]); };
  auto dhb = [&](int b) { return reinterpret_cast<__nv_bfloat16*>(chain_smem + s.dh[b]); };
  const int L = c.L, d0 = c.d[0], dl = c.d[L];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool staged_dx = !direct_rows(d0);
  const int tiles = (n + kRows - 1) / kRows;
  const int t0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * tiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * tiles / gridDim.x);
  float* part = partials + static_cast<int64_t>(blockIdx.x) * c.p_count;
  Owned own;
  if constexpr (kOwn) {
    own.w = warp;
    own.count = (c.t_off[L] - warp + kWarps - 1) / kWarps;
#pragma unroll
    for (int q = 0; q < kOwnMax; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) own.v[q][e] = 0.f;
  }
  auto fetch = [&](int tile) {  // x's and g's tiles into their stages
    if (tile < t1) {
      const int64_t r = static_cast<int64_t>(tile) * kRows;
      stage_span(x + r * d0, tile_rows(n, r) * d0, xs);
      stage_span(g + r * dl, tile_rows(n, r) * dl, gs);
    }
    cp_async_commit();
  };
  if (c.res_bwd) stage_weights(c, packed, chain_smem + s.w);
  fetch(t0);
  for (int tile = t0; tile < t1; ++tile) {
    const bool first = tile == t0;
    const int64_t r0 = static_cast<int64_t>(tile) * kRows;
    const int rows = tile_rows(n, r0);
    cp_async_wait<0>();
    __syncthreads();  // x's and g's tiles (and the weights) have landed
    // x in bf16; g: db of the last layer (f32 column sums) and the first dh
    stage_to_bf16(xs, rows, d0, act(0), pad16(d0) + kSkew);
    column_sums(gs, rows, dl, dl, part + c.p_off[L - 1] + int64_t{c.d[L - 1]} * dl, first);
    stage_to_bf16(gs, rows, dl, dhb(0), s.dh_ld[0]);
    __syncthreads();
    if (c.res_bwd) fetch(tile + 1);  // the ring's waits would wait for it too
    // the recompute of every layer's input (K1's code)
    for (int l = 0; l + 1 < L; ++l) {
      const Weights wt =
          layer_weights(c, c.res_bwd, packed, chain_smem + s.w, l, ring, s.ring_elems);
      layer_forward<false>(c, packed, l, wt, act(l), pad16(c.d[l]) + kSkew, act(l + 1),
                           pad16(c.d[l + 1]) + kSkew, nullptr, rows);
      __syncthreads();
    }
    for (int l = L - 1, cur = 0; l >= 0; --l, cur ^= 1) {
      const int din = c.d[l], dout = c.d[l + 1];
      const __nv_bfloat16* dh = dhb(cur);
      const int ldd = s.dh_ld[cur], lda = pad16(din) + kSkew;
      float* pw = part + c.p_off[l];
      const Weights wt =
          layer_weights(c, c.res_bwd, packed, chain_smem + s.w, l, ring, s.ring_elems);
      if (l == 0 && dx != nullptr) {
        // dx = dh_0 . W_0^T, stored as K1 stores y; first, so that its stores
        // drain while dW_0 is summed
        float* out = dx + r0 * d0;
        for (int n0 = 0; n0 < pad16(d0); n0 += kMaxN)
          product<false>(dh, ldd, 0, wt, pad16(dout), n0, min(kMaxN, pad16(d0) - n0),
                         [&](int r, int col, float v0, float v1) {
                           const int i = n0 + col;
                           if (!staged_dx) {
                             if (r < rows && i < d0)
                               *reinterpret_cast<float2*>(out + static_cast<int64_t>(r) * d0 + i) =
                                   make_float2(v0, v1);
                           } else {
                             if (i < d0) rs[r * d0 + i] = v0;
                             if (i + 1 < d0) rs[r * d0 + i + 1] = v1;
                           }
                         });
        if (staged_dx) {
          __syncthreads();
          store_span(rs, rows * d0, out);
        }
      }
      // dW_l += a_l^T . dh_l over the tile's rows: into the owned sums, else
      // into the partials in device memory
      if constexpr (kOwn) {
        owned_product(own, c, l, act(l), lda, dh, ldd, lane);
      } else {
        for (int m0 = 0; m0 < pad16(din); m0 += kRows)
          for (int n0 = 0; n0 < pad16(dout); n0 += kMaxN)
            rows_product(act(l), lda, m0, min(4, (pad16(din) - m0) / 16), dh, ldd, n0,
                         min(kMaxN, pad16(dout) - n0), [&](int r, int col, float v0, float v1) {
                           const int i = m0 + r, j = n0 + col;
                           if (i < din) {
                             if (j < dout) add_partial(pw, int64_t{i} * dout + j, v0, first);
                             if (j + 1 < dout)
                               add_partial(pw, int64_t{i} * dout + j + 1, v1, first);
                           }
                         });
      }
      if (l == 0) break;
      // dh_{l-1} = (dh_l . W_l^T) where a_l > 0, rounded to bf16 for the next
      // products; db_{l-1}, its f32 column sums: each warp's 16 rows summed in
      // registers and across its lanes (a fixed shuffle tree), the 4 row
      // tiles' sums then added in order
      const __nv_bfloat16* mask = act(l);
      __nv_bfloat16* next = dhb(cur ^ 1);
      const int ldn = s.dh_ld[cur ^ 1], kp = pad16(din);
      for (int n0 = 0; n0 < kp; n0 += kMaxN) {
        float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // n-tile h's two columns
        product<false>(dh, ldd, 0, wt, pad16(dout), n0, min(kMaxN, kp - n0),
                       [&](int r, int col, float v0, float v1) {
                         const int i = n0 + col, h = (col >> 3) & 1;
                         const __nv_bfloat162 m =
                             *reinterpret_cast<const __nv_bfloat162*>(mask + r * lda + i);
                         const float h0 = __bfloat162float(m.x) > 0.f ? v0 : 0.f;
                         const float h1 = __bfloat162float(m.y) > 0.f ? v1 : 0.f;
                         *reinterpret_cast<uint32_t*>(next + r * ldn + i) = pack_bf16x2(h0, h1);
                         cs[h][0] += h0;
                         cs[h][1] += h1;
                       });
        const Split sp = split_for(min(kMaxN, kp - n0) / 16);
        if (sp.has_mt && sp.pn > 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int o = 4; o < 32; o <<= 1) cs[h][e] += __shfl_xor_sync(0xffffffffu, cs[h][e], o);
          if (lane < 4)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(rs + sp.mt * kp + n0 + 16 * sp.p0 + 8 * h + 2 * lane) =
                  make_float2(cs[h][0], cs[h][1]);
        }
      }
      __syncthreads();
      float* pb = part + c.p_off[l - 1] + int64_t{c.d[l - 1]} * din;
      for (int col = threadIdx.x; col < din; col += kThreads)
        add_partial(pb, col, ((rs[col] + rs[kp + col]) + rs[2 * kp + col]) + rs[3 * kp + col],
                    first);
      __syncthreads();
    }
    if (!c.res_bwd) fetch(tile + 1);
    __syncthreads();  // the stages are rewritten by the next tile's conversion
  }
  if constexpr (kOwn) owned_store(own, c, part, lane);
}

// ---------------------------------------------------------------- host side

// K2's blocks: one per fixed range of tiles, kSplitTarget at most (so the
// ranges, and the order of the sums, depend on the chain and n only).
inline int bwd_blocks(int64_t n) {
  const int64_t tiles = (n + kRows - 1) / kRows;
  return static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(tiles, general::kSplitTarget)));
}

inline size_t fwd_scratch_bytes(const int* d, int L) { return general::packed_bytes(d, L, true); }

inline size_t bwd_scratch_bytes(const int* d, int L, int64_t n) {
  const Chain c = make_chain(d, L);
  return general::packed_bytes(d, L, true) +
         general::al256(sizeof(float) * static_cast<size_t>(bwd_blocks(n)) * c.p_count);
}

inline cudaError_t forward(const float* x, const float* params, float* y, int n, const int* d,
                           int L, void* scratch, cudaStream_t stream) {
  general::Carve cv{static_cast<char*>(scratch)};
  general::Packed<__nv_bfloat16> pk;
  cudaError_t err = general::pack_weights<__nv_bfloat16>(params, d, L, cv, pk, stream);
  if (err != cudaSuccess || n == 0) return err;
  const Chain c = make_chain(d, L);
  const int smem = fwd_smem(c).bytes;
  auto kernel = mlp_chain_fwd_kernel;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kRows - 1) / kRows;
  const int grid = std::max(1, std::min(tiles, std::max(per_sm, 1) * num_sms()));
  kernel<<<grid, kThreads, smem, stream>>>(x, static_cast<const char*>(scratch), y, n, c);
  return cudaGetLastError();
}

inline cudaError_t backward(const float* x, const float* g, const float* params, float* dx,
                            float* dparams, int n, const int* d, int L, void* scratch,
                            cudaStream_t stream) {
  general::Carve cv{static_cast<char*>(scratch)};
  general::Packed<__nv_bfloat16> pk;
  cudaError_t err = general::pack_weights<__nv_bfloat16>(params, d, L, cv, pk, stream);
  if (err != cudaSuccess) return err;
  const Chain c = make_chain(d, L);
  float* partials = reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                             general::packed_bytes(d, L, true));
  if (n == 0) return cudaMemsetAsync(dparams, 0, sizeof(float) * c.p_count, stream);
  const int smem = bwd_smem(c).bytes;
  auto kernel = c.own ? mlp_chain_bwd_kernel<true> : mlp_chain_bwd_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = bwd_blocks(n);
  kernel<<<blocks, kThreads, smem, stream>>>(x, g, static_cast<const char*>(scratch), dx,
                                              partials, n, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  general::mlp_sum_rows_kernel<<<static_cast<unsigned>(general::ceil_div(c.p_count, 256)), 256,
                                 0, stream>>>(partials, c.p_count, blocks,
                                              static_cast<int>(c.p_count), dparams, 0);
  return cudaGetLastError();
}

}  // namespace chain
}  // namespace umhs
