// K4: multi-resolution hash-grid encode, backward, with a fixed order of
// summation.
//
// Replaces umhs_tpu/ops/encodings.py::_hash_encode_bwd (lines 501-583, the
// custom VJP of _hash_encode_impl). On the TPU that is XLA scatter-adds laid
// out by hand; this kernel plays the role tiny-cuda-nn's HashGrid backward
// had in the original system.
//
// What it computes, into the zeroed f32 gradient table grad[row * F + f]:
// for each (sample s, level l) the vertex rows and weights come from
// umhs::hash_vertices (hash_grid.cuh, the same function K3 gathers with), and
// - deterministic: w_v * g[s, l * F + f] goes to each of the V vertices;
// - stochastic: g itself goes to one vertex, drawn with probability w_v (an
//   unbiased estimate with V times fewer adds). The uniform variate is the
//   position hash of encodings.py:529-536: u = frac(sin(p . c) * 43758.5453)
//   with c = (12.9898, 78.233, 37.719), the dot taken as ((x c0 + y c1) +
//   z c2) with every product and sum rounded (no FMA), precise sinf (this
//   source is built without --use_fast_math), then u_l = frac(u + l *
//   0.6180339887). The vertex is the first v with u_l < w_0 + ... + w_v
//   (running f32 sums), else the last: exactly one vertex per (sample,
//   level). frac is torch.remainder(., 1), so the plain version
//   (umhs_torch/ops/encodings.py) computes the same bits.
//
// The order of the sums is fixed: each table entry is +0 plus its
// contributions in ascending entry index e = (s * L + l) * V + v
// (deterministic) or s * L + l (stochastic), one __fadd_rn at a time, and a
// deterministic contribution is __fmul_rn(w_v, g), never an FMA into the
// sum. That is the order in which the plain version's 1-D index_add_ adds
// on the CPU, so the two give the same bits, and a run repeats bit for bit.
// No float atomics: every integer count is order-free, and every table row
// is written by one lane.
//
// The pipeline, one launch of the wrapper (every buffer comes from the
// wrapper's scratch tensor; umhs_hash_encode_bwd_scratch_bytes sizes it):
// 1. emit: one thread per sample walks the levels and writes each of its
//    entries into a slot, level-major: slot k = (l * n + s) * VE + v (VE = V,
//    or 1 when stochastic), as a key, the row, and the F values it adds (g,
//    or __fmul_rn(w_v, g)). A row belongs to one level, so within a row
//    ascending slot order is ascending e. An entry whose values are all zero
//    (the compact buffer's padding rows) gets the key kSkip: adding it
//    would change no bit, since the table starts at +0.
// 2. a stable LSD radix sort of the entries by key on 8-bit digits, as many
//    passes as the table's row count needs (3 at L16 2^19: 6,098,108 rows
//    < 2^23), the values moving with their keys. Each pass:
//    digit_count_kernel counts each tile's digits, digit_scan_kernel scans
//    the counts over the tiles of each digit, and digit_scatter_kernel
//    places each entry at its digit's start + the earlier tiles' count + its
//    rank among the tile's earlier entries of that digit (ranks from warp
//    ballots over the digit's bits), through a copy of the tile in shared
//    memory laid out in digit order, so that the stores to device memory
//    coalesce. The first pass drops the kSkip entries and records how many
//    remain.
// 3. row_sum_kernel: each warp owns 256 sorted entries, 8 consecutive ones
//    a lane, and sums every row whose run starts there: each lane adds the
//    runs that start in its entries, and a run that crosses lanes is carried
//    from lane to lane in order, on past the warp's entries while it lasts.
//
// What bounds it on an H100: bytes. Per entry the sort reads and writes a
// key and F values once per pass, all in order but the placement's digit
// runs, and the sum writes each touched table row once, at random; the
// table is zeroed by the wrapper. A dense level's row can hold thousands of
// entries, whose sum is one chain of dependent adds, fed 256 entries a round.
#include <stdint.h>

#include "common.cuh"
#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;  // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kRun = 8;  // consecutive sorted entries per lane in the sum
constexpr int kSumBatch = 32 * kRun;  // sorted entries per warp round of the sum
constexpr uint32_t kSkip = 0xffffffffu;  // key of an entry that adds nothing
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kDigits, "one thread per digit in the scans");
using umhs::Levels;

// torch.remainder(v, 1.f): fmod, shifted into [0, 1) for negative v.
__device__ __forceinline__ float frac1(float v) {
  float r = fmodf(v, 1.f);
  if (r != 0.f && r < 0.f) r += 1.f;
  return r;
}

__device__ __forceinline__ float position_uniform(const float p[3]) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(p[0], 12.9898f), __fmul_rn(p[1], 78.233f)),
                              __fmul_rn(p[2], 37.719f));
  return frac1(__fmul_rn(sinf(dot), 43758.5453f));
}

__device__ __forceinline__ float level_uniform(float u, int l) {
  return frac1(__fadd_rn(u, __fmul_rn(static_cast<float>(l), 0.6180339887f)));
}

// The F gradients of one (sample, level), in one or two vector loads.
template <int F>
__device__ __forceinline__ void load_row(const float* p, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(p);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = a.x;
      v[4 * i + 1] = a.y;
      v[4 * i + 2] = a.z;
      v[4 * i + 3] = a.w;
    }
  }
}

// One table row's F sums, in one or two vector stores.
template <int F>
__device__ __forceinline__ void store_row(float* p, const float (&v)[F]) {
  if constexpr (F == 1) {
    p[0] = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < F / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

template <int F>
__device__ __forceinline__ bool all_zero(const float (&v)[F]) {
  bool zero = true;
#pragma unroll
  for (int f = 0; f < F; ++f) zero = zero && v[f] == 0.f;
  return zero;
}

// 1. One thread per sample: every entry's key and values into its slot.
template <int F, bool kTetra, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const float* __restrict__ pos, const float* __restrict__ g,
            uint32_t* __restrict__ keys, float* __restrict__ vals, uint32_t n, int L, Levels lv) {
  const uint32_t s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const float p[3] = {__ldg(pos + 3 * s), __ldg(pos + 3 * s + 1), __ldg(pos + 3 * s + 2)};
  const float u = kStochastic ? position_uniform(p) : 0.f;
  const float* gs = g + static_cast<size_t>(s) * L * F;  // g[s, l * F + f]
  constexpr int V = kTetra ? 4 : 8;
  constexpr int VE = kStochastic ? 1 : V;
  for (int l = 0; l < L; ++l) {
    uint32_t rows[V];
    float w[V];
    umhs::hash_vertices<kTetra>(p, l, lv, rows, w);
    float gv[F];
    load_row<F>(gs + l * F, gv);
    const size_t k = (static_cast<size_t>(l) * n + s) * VE;
    if (kStochastic) {
      const float ul = level_uniform(u, l);
      uint32_t row = rows[V - 1];
      bool found = false;
      float cum = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        cum = v == 0 ? w[0] : __fadd_rn(cum, w[v]);
        if (!found && ul < cum) {
          row = rows[v];
          found = true;
        }
      }
      keys[k] = all_zero<F>(gv) ? kSkip : row;
      store_row<F>(vals + k * F, gv);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float c[F];
#pragma unroll
        for (int f = 0; f < F; ++f) c[f] = __fmul_rn(w[v], gv[f]);
        keys[k + v] = all_zero<F>(c) ? kSkip : rows[v];
        store_row<F>(vals + (k + v) * F, c);
      }
    }
  }
}

// Exclusive prefix of v over the block's threads in thread order; *total
// gets the block's sum. Every thread of the block calls it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t s = warp_sums[w];
    before += w < warp ? s : 0u;
    all += s;
  }
  __syncthreads();  // warp_sums may be written again
  *total = all;
  return before + x - v;
}

// Entries per lane in a sort tile: the staged tile's keys and values fit
// 48 KB of shared memory beside the counters.
__host__ __device__ constexpr int sort_items(int F) { return F == 1 ? 16 : (F == 2 ? 8 : 4); }

// 2a. Digit counts of one tile: counts[d * tiles + tile]. Entries past the
// live count (*count, or m where count is null) and kSkip keys are not counted.
template <int kItems>
__global__ void __launch_bounds__(kThreads)
digit_count_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ count,
                   uint32_t m, int shift, uint32_t* __restrict__ counts, uint32_t tiles) {
  __shared__ uint32_t hist[kDigits];
  hist[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t live = count ? *count : m;
  const size_t base = static_cast<size_t>(blockIdx.x) * kThreads * kItems;
#pragma unroll 4
  for (int i = 0; i < kItems; ++i) {
    const size_t idx = base + static_cast<size_t>(i) * kThreads + threadIdx.x;
    if (idx >= live) break;
    const uint32_t key = keys[idx];
    if (key != kSkip) atomicAdd(&hist[(key >> shift) & (kDigits - 1)], 1u);
  }
  __syncthreads();
  counts[static_cast<size_t>(threadIdx.x) * tiles + blockIdx.x] = hist[threadIdx.x];
}

// 2b. One block per digit: its counts turned into exclusive prefixes over
// the tiles, in place; totals[d] = the digit's count.
__global__ void __launch_bounds__(kThreads)
digit_scan_kernel(uint32_t* __restrict__ counts, uint32_t tiles, uint32_t* __restrict__ totals) {
  uint32_t* c = counts + static_cast<size_t>(blockIdx.x) * tiles;
  uint32_t carry = 0;
  for (uint32_t start = 0; start < tiles; start += kThreads) {
    const uint32_t idx = start + threadIdx.x;
    const uint32_t v = idx < tiles ? c[idx] : 0u;
    uint32_t chunk;
    const uint32_t before = block_exclusive_scan(v, &chunk);
    if (idx < tiles) c[idx] = carry + before;
    carry += chunk;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// 2c. Stable placement of one tile's entries (key and F values) by their
// digit. Warp w takes the tile's entries w * 32 * kItems + j * 32 + lane,
// j = 0..kItems-1, in index order, and ranks each among the warp's earlier
// entries of its digit (ballots over the digit's bits). The tile is then
// laid out in shared memory in digit order and written out a digit run at a
// time, so that neighbouring lanes store to neighbouring addresses. The
// first pass drops kSkip keys; its block 0 writes the live count.
template <int F, bool kFirst>
__global__ void __launch_bounds__(kThreads)
digit_scatter_kernel(const uint32_t* __restrict__ keys_in, const float* __restrict__ vals_in,
                     uint32_t* __restrict__ keys_out, float* __restrict__ vals_out,
                     uint32_t* __restrict__ count, uint32_t m, int shift,
                     const uint32_t* __restrict__ counts, uint32_t tiles,
                     const uint32_t* __restrict__ totals) {
  constexpr int kItems = sort_items(F);
  constexpr int kTile = kThreads * kItems;
  __shared__ uint32_t start[kDigits];  // where this tile's entries of digit d go in the output
  __shared__ uint32_t local[kDigits];  // where they go in the staged tile
  __shared__ uint32_t warp_count[kWarps][kDigits];
  __shared__ uint32_t staged_keys[kTile];
  __shared__ __align__(16) float staged_vals[kTile * F];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t total;
  const uint32_t digit_start = block_exclusive_scan(totals[t], &total);
  start[t] = digit_start + counts[static_cast<size_t>(t) * tiles + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w][t] = 0;
  if (kFirst && blockIdx.x == 0 && t == 0) *count = total;
  const uint32_t live = kFirst ? m : *count;
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile + warp * (32 * kItems) + lane;
  uint32_t key[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const size_t idx = base + 32 * j;
    bool valid = idx < live;
    key[j] = valid ? keys_in[idx] : kSkip;
    if (kFirst) valid = valid && key[j] != kSkip;
    const uint32_t d = (key[j] >> shift) & (kDigits - 1);
    unsigned peers = __ballot_sync(kFull, valid);  // the valid lanes of the same digit
#pragma unroll
    for (int b = 0; b < kDigitBits; ++b) {
      const bool bit = (d >> b) & 1u;
      const unsigned set = __ballot_sync(kFull, bit);
      peers &= bit ? set : ~set;
    }
    rank[j] = valid ? warp_count[warp][d] + __popc(peers & below) : kSkip;
    __syncwarp();
    if (valid && (peers & below) == 0u) warp_count[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  uint32_t run = 0;  // thread t: digit t's counts over the warps -> prefixes
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = warp_count[w][t];
    warp_count[w][t] = run;
    run += c;
  }
  uint32_t in_tile;
  local[t] = block_exclusive_scan(run, &in_tile);  // syncs: warp_count is complete
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (rank[j] == kSkip) continue;
    const uint32_t d = (key[j] >> shift) & (kDigits - 1);
    const uint32_t at = local[d] + warp_count[warp][d] + rank[j];
    staged_keys[at] = key[j];
    float v[F];
    load_row<F>(vals_in + (base + 32 * j) * F, v);
    store_row<F>(staged_vals + static_cast<size_t>(at) * F, v);
  }
  __syncthreads();
  for (uint32_t i = t; i < in_tile; i += kThreads) {
    const uint32_t k = staged_keys[i];
    const uint32_t d = (k >> shift) & (kDigits - 1);
    const size_t at = start[d] + (i - local[d]);
    keys_out[at] = k;
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = staged_vals[i * F + f];
    store_row<F>(vals_out + at * F, v);
  }
}

// 3. Each warp owns the sorted entries [256 w, 256 w + 256), kRun = 8
// consecutive ones per lane, and sums, from +0 and in order, every row whose
// run starts there. A lane adds the runs that start in its entries; a run
// that ends in the lane is written there, and the last one is carried on.
// Then the carried run flows through the lanes in order, 32 steps of one
// shuffle each: lane k adds its entries before its first start (the head)
// to what lane k - 1 passes on, and writes the run where it ends. A run that
// flows past the warp's entries is followed round by round.
template <int F>
__global__ void __launch_bounds__(kThreads)
row_sum_kernel(const uint32_t* __restrict__ keys, const float* __restrict__ vals,
               const uint32_t* __restrict__ count, float* __restrict__ grad) {
  const uint32_t live = *count;
  const size_t first = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) / 32 * kSumBatch;
  if (first >= live) return;  // uniform across the warp
  const int lane = threadIdx.x & 31;

  // the run flowing into a round: its sum so far, its row, and whether this
  // warp writes it (a run that starts before the warp's entries is another's)
  float carry[F];
#pragma unroll
  for (int f = 0; f < F; ++f) carry[f] = 0.f;
  uint32_t carry_row = kSkip;
  bool carry_owned = false;
  uint32_t before = first > 0 ? keys[first - 1] : kSkip;  // the key before the round
  bool own_round = true;  // runs may start only in the warp's own entries

  for (size_t at = first; at < live; at += kSumBatch) {
    uint32_t kk[kRun];  // this lane's entries: keys (kSkip past the live count) and values
    float x[kRun][F];
    const size_t mine = at + lane * kRun;
#pragma unroll
    for (int c = 0; c < kRun; ++c) {
      const bool valid = mine + c < live;
      kk[c] = valid ? keys[mine + c] : kSkip;
      if (valid) {
        load_row<F>(vals + (mine + c) * F, x[c]);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) x[c][f] = 0.f;
      }
    }
    uint32_t prev = __shfl_up_sync(kFull, kk[kRun - 1], 1);
    if (lane == 0) prev = before;
    before = __shfl_sync(kFull, kk[kRun - 1], 31);
    int head = kRun;  // entries before the lane's first start
#pragma unroll
    for (int c = kRun - 1; c >= 0; --c)
      if (kk[c] != (c > 0 ? kk[c - 1] : prev)) head = c;

    float tail[F];  // the lane's last run that starts in it
#pragma unroll
    for (int f = 0; f < F; ++f) tail[f] = 0.f;
    uint32_t tail_row = kSkip;
    if (own_round) {
#pragma unroll
      for (int c = 0; c < kRun; ++c) {
        if (c < head) continue;
        if (kk[c] != (c > 0 ? kk[c - 1] : prev)) {
          if (tail_row != kSkip) store_row<F>(grad + static_cast<size_t>(tail_row) * F, tail);
#pragma unroll
          for (int f = 0; f < F; ++f) tail[f] = 0.f;
          tail_row = kk[c];
        }
#pragma unroll
        for (int f = 0; f < F; ++f) tail[f] = __fadd_rn(tail[f], x[c][f]);
      }
    }

    float out[F];  // what this lane passes on
#pragma unroll
    for (int f = 0; f < F; ++f) out[f] = 0.f;
    uint32_t out_row = kSkip;
    bool out_owned = false;
    for (int k = 0; k < 32; ++k) {
      const int src = k > 0 ? k - 1 : 0;
      float in[F];
#pragma unroll
      for (int f = 0; f < F; ++f) in[f] = __shfl_sync(kFull, out[f], src);
      uint32_t in_row = __shfl_sync(kFull, out_row, src);
      bool in_owned = __shfl_sync(kFull, out_owned, src);
      if (k == 0) {
#pragma unroll
        for (int f = 0; f < F; ++f) in[f] = carry[f];
        in_row = carry_row;
        in_owned = carry_owned;
      }
      if (lane == k) {
#pragma unroll
        for (int c = 0; c < kRun; ++c) {
          if (c < head) {
#pragma unroll
            for (int f = 0; f < F; ++f) in[f] = __fadd_rn(in[f], x[c][f]);
          }
        }
        if (head < kRun) {  // the incoming run ends in this lane
          if (in_owned && in_row != kSkip) store_row<F>(grad + static_cast<size_t>(in_row) * F, in);
#pragma unroll
          for (int f = 0; f < F; ++f) out[f] = tail[f];
          out_row = tail_row;
          out_owned = own_round;
        } else {
#pragma unroll
          for (int f = 0; f < F; ++f) out[f] = in[f];
          out_row = in_row;
          out_owned = in_owned;
        }
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) carry[f] = __shfl_sync(kFull, out[f], 31);
    carry_row = __shfl_sync(kFull, out_row, 31);
    carry_owned = __shfl_sync(kFull, out_owned, 31);
    own_round = false;
    if (!carry_owned || carry_row == kSkip) return;
  }
  // the live entries ended inside the carried run
  if (lane == 0) store_row<F>(grad + static_cast<size_t>(carry_row) * F, carry);
}

uint32_t sort_passes(uint32_t table_rows) {
  uint32_t bits = 0;
  while (bits < 32 && ((table_rows - 1u) >> bits) != 0u) ++bits;
  return bits == 0 ? 1u : (bits + kDigitBits - 1) / kDigitBits;
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// The scratch's layout: keys (m u32) and values (m x F f32), twice, then the
// digit counts, the digit totals and the live count.
struct Scratch {
  uint32_t *keys_a, *keys_b, *counts, *totals, *count;
  float *vals_a, *vals_b;
  size_t bytes;
};

Scratch scratch_layout(void* base, uint64_t m, int F) {
  const uint64_t tile = kThreads * sort_items(F);
  const uint64_t tiles = (m + tile - 1) / tile;
  char* p = static_cast<char*>(base);
  Scratch s{};
  size_t off = 0;
  auto take = [&](size_t b) {
    char* at = p ? p + off : nullptr;
    off += align256(b);
    return at;
  };
  s.keys_a = reinterpret_cast<uint32_t*>(take(m * 4));
  s.keys_b = reinterpret_cast<uint32_t*>(take(m * 4));
  s.vals_a = reinterpret_cast<float*>(take(m * 4 * F));
  s.vals_b = reinterpret_cast<float*>(take(m * 4 * F));
  s.counts = reinterpret_cast<uint32_t*>(take(static_cast<size_t>(kDigits) * tiles * 4));
  s.totals = reinterpret_cast<uint32_t*>(take(kDigits * 4));
  s.count = reinterpret_cast<uint32_t*>(take(4));
  s.bytes = off;
  return s;
}

uint64_t entries(int64_t n, int L, bool tetra, bool stochastic) {
  return static_cast<uint64_t>(n) * L * (stochastic ? 1 : (tetra ? 4 : 8));
}

constexpr uint64_t kMaxEntries = 0x7fffffffull;  // slot indices fit int32

template <int F, bool kTetra, bool kStochastic>
cudaError_t launch(const float* pos, const float* g, float* grad, uint32_t n, int L,
                   const Levels& lv, uint32_t table_rows, const Scratch& sc, cudaStream_t stream) {
  constexpr int VE = kStochastic ? 1 : (kTetra ? 4 : 8);
  constexpr int kItems = sort_items(F);
  const uint32_t m = n * L * VE;
  const uint32_t tiles = (m + kThreads * kItems - 1) / (kThreads * kItems);
  emit_kernel<F, kTetra, kStochastic><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pos, g, sc.keys_b, sc.vals_b, n, L, lv);
  const uint32_t passes = sort_passes(table_rows);
  uint32_t *src_k = sc.keys_b, *dst_k = sc.keys_a;
  float *src_v = sc.vals_b, *dst_v = sc.vals_a;
  for (uint32_t p = 0; p < passes; ++p) {
    const int shift = static_cast<int>(p) * kDigitBits;
    const uint32_t* live = p == 0 ? nullptr : sc.count;
    digit_count_kernel<kItems><<<tiles, kThreads, 0, stream>>>(src_k, live, m, shift, sc.counts,
                                                               tiles);
    digit_scan_kernel<<<kDigits, kThreads, 0, stream>>>(sc.counts, tiles, sc.totals);
    if (p == 0)
      digit_scatter_kernel<F, true><<<tiles, kThreads, 0, stream>>>(
          src_k, src_v, dst_k, dst_v, sc.count, m, shift, sc.counts, tiles, sc.totals);
    else
      digit_scatter_kernel<F, false><<<tiles, kThreads, 0, stream>>>(
          src_k, src_v, dst_k, dst_v, sc.count, m, shift, sc.counts, tiles, sc.totals);
    uint32_t* k = src_k;
    src_k = dst_k;
    dst_k = k;
    float* v = src_v;
    src_v = dst_v;
    dst_v = v;
  }
  const uint64_t warps = (static_cast<uint64_t>(m) + kSumBatch - 1) / kSumBatch;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  row_sum_kernel<F><<<blocks, kThreads, 0, stream>>>(src_k, src_v, sc.count, grad);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_f(const float* pos, const float* g, float* grad, uint32_t n, int L,
                     const Levels& lv, uint32_t rows, const Scratch& sc, bool tetra,
                     bool stochastic, cudaStream_t s) {
  if (tetra)
    return stochastic ? launch<F, true, true>(pos, g, grad, n, L, lv, rows, sc, s)
                      : launch<F, true, false>(pos, g, grad, n, L, lv, rows, sc, s);
  return stochastic ? launch<F, false, true>(pos, g, grad, n, L, lv, rows, sc, s)
                    : launch<F, false, false>(pos, g, grad, n, L, lv, rows, sc, s);
}

}  // namespace

// Bytes of scratch device memory umhs_hash_encode_bwd needs for n samples
// at L levels of F features; 0 when n * L * (vertices per entry) exceeds
// 2^31 - 1 entries.
extern "C" int64_t umhs_hash_encode_bwd_scratch_bytes(int64_t n, int L, int F, int tetrahedral,
                                                      int stochastic) {
  const uint64_t m = entries(n, L, tetrahedral != 0, stochastic != 0);
  if (n < 0 || L < 1 || (F != 1 && F != 2 && F != 4 && F != 8) || m > kMaxEntries) return 0;
  return static_cast<int64_t>(scratch_layout(nullptr, m, F).bytes);
}

// pos: (n, 3) f32 in [0, 1]; g: (n, L * F) f32, the gradient of K3's
// output, aligned to 4 * F bytes; grad: (rows * F,) f32, aligned to 4 * F
// bytes, zeroed by the caller; every row with a contribution is written.
// scales/res/offsets/dense: per-level host arrays of length L. scratch:
// umhs_hash_encode_bwd_scratch_bytes(...) bytes of device memory, aligned to
// 256, given as scratch_bytes. Returns a cudaError_t.
extern "C" int umhs_hash_encode_bwd(const float* pos, const float* g, float* grad,
                                    int64_t n, int L, int F, const float* scales,
                                    const int* res, const int* offsets, const int* dense,
                                    int log2_hashmap_size, int tetrahedral, int stochastic,
                                    void* scratch, int64_t scratch_bytes, void* stream) {
  Levels lv;
  if (n < 0 || (F != 1 && F != 2 && F != 4 && F != 8) ||
      !umhs::fill_levels(lv, L, scales, res, offsets, dense, log2_hashmap_size))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(g) % (4 * F) != 0 ||
      reinterpret_cast<uintptr_t>(grad) % (4 * F) != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 256 != 0)
    return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  const bool tetra = tetrahedral != 0, stoch = stochastic != 0;
  const uint64_t m = entries(n, L, tetra, stoch);
  if (m > kMaxEntries) return cudaErrorInvalidValue;
  const Scratch sc = scratch_layout(scratch, m, F);
  if (scratch == nullptr || scratch_bytes < static_cast<int64_t>(sc.bytes))
    return cudaErrorInvalidValue;
  const int last = L - 1;
  const uint64_t last_rows = dense[last] ? static_cast<uint64_t>(res[last]) * res[last] * res[last]
                                         : static_cast<uint64_t>(lv.hash_mask) + 1u;
  const uint32_t rows = static_cast<uint32_t>(offsets[last] + last_rows);
  auto s = static_cast<cudaStream_t>(stream);
  const uint32_t n32 = static_cast<uint32_t>(n);
  switch (F) {
    case 1: return launch_f<1>(pos, g, grad, n32, L, lv, rows, sc, tetra, stoch, s);
    case 2: return launch_f<2>(pos, g, grad, n32, L, lv, rows, sc, tetra, stoch, s);
    case 4: return launch_f<4>(pos, g, grad, n32, L, lv, rows, sc, tetra, stoch, s);
    case 8: return launch_f<8>(pos, g, grad, n32, L, lv, rows, sc, tetra, stoch, s);
    default: return cudaErrorInvalidValue;
  }
}
