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
// An entry whose values are all zero (the compact buffer's padding rows) is
// dropped: a sum that starts at +0 never becomes -0, so adding +-0 changes no
// bit. No float atomics: every integer count is order-free, and every table
// row is summed by one lane.
//
// Each level takes one of two routes, as the wrapper's rule says
// (hash_encode_bwd_route in umhs_torch/ops/encodings.py; both give the same
// bits, so the rule only picks the faster). Every buffer comes from the
// wrapper's scratch tensor, sized by umhs_hash_encode_bwd_scratch_bytes; the
// routes run one after the other on the stream and share it.
//
// Route "runs" (coarse levels, where ray-ordered samples hit the same rows
// again and again): what gets sorted globally is runs of entries, not entries.
// 1. run_emit_kernel: a block takes a chunk of C consecutive samples at one
//    level (C * VE = chunk_entries(F) entries, 2,048 at F <= 2), computes
//    their entries, keeps the nonzero ones in ascending e, and sorts them in
//    shared memory by the low 16 bits of the level-local row, stably (two
//    8-bit passes of warp-ballot ranks, as the global sort's). A run is a
//    stretch of equal rows in that order; its values are written contiguous
//    into the chunk's slots of the values buffer, and one descriptor per run
//    (row, [start, end) of its values) into the chunk's slots. Two rows that
//    share the low 16 bits stay in ascending e among themselves, so a row's
//    runs within a chunk are still in ascending e (only shorter).
// 2. digit_scan_kernel over the chunks' run counts and compact_runs_kernel
//    pack the descriptors in chunk order; a stable LSD radix sort of the
//    descriptors (the kernels of the other route on 9-bit digits, moving the
//    two-word span with each key) by the low bits of the row that tell a
//    level's rows apart (two passes for levels of 2^17 rows; two levels'
//    rows with the same low bits stay in level order) keeps each row's runs
//    together and in chunk order. A chunk is a range of e within one level,
//    so a row's runs in that order hold its entries in ascending e.
// 3. run_fold_kernel: a warp takes the rows whose first run is among its 32
//    sorted descriptors; per row its lanes read 32 runs' values at a time
//    into shared memory, in order, and lanes 0..F-1 add them from +0 one by
//    one, a feature each.
//
// Route "entries" (fine levels, ~1 entry per run): every entry is sorted.
// 1. emit_kernel: one thread per sample walks the route's levels and writes
//    each entry into a slot, level-major: slot k = (i * n + s) * VE + v for
//    the route's i-th level (VE = V, or 1 when stochastic), as a key (the
//    row, or kSkip when its values are all zero) and the F values it adds.
//    A row belongs to one level, so within a row ascending slot order is
//    ascending e.
// 2. the stable LSD radix sort of the entries by key on 8-bit digits, as many
//    passes as the route's rows need (3 at L16 2^19: 6,098,108 rows < 2^23),
//    the values moving with their keys. Each pass: digit_count_kernel counts
//    each tile's digits, digit_scan_kernel scans the counts over the tiles of
//    each digit, and digit_scatter_kernel places each entry at its digit's
//    start + the earlier tiles' count + its rank among the tile's earlier
//    entries of that digit (ranks from warp ballots over the digit's bits),
//    through a copy of the tile in shared memory laid out in digit order, so
//    that the stores to device memory coalesce. The first pass drops the
//    kSkip entries and records how many remain.
// 3. row_sum_kernel: each warp owns 256 sorted entries, 8 consecutive ones
//    a lane, and sums every row whose run starts there: each lane adds the
//    runs that start in its entries, and a run that crosses lanes is carried
//    from lane to lane in order, on past the warp's entries while it lasts.
//
// Any F, any number of levels (every shape but F 1, 2, 4 or 8 at most 32
// levels, whose template instances above take it): the same two routes,
// the level arguments from a device table (hash_grid.cuh's LevelArg), the
// features in groups of at most kGroup = 8 (each group a template instance
// of F 1..8; the groups' sums are apart, so each group runs on its own).
// - The runs route as above, its levels in lists of at most 32, a feature
//   group at a time.
// - The entries route: emit_any_kernel (a thread a (sample, level)) writes
//   each entry's key and its F values at slot k, level-major, the values
//   padded to a multiple of 4 floats (one 32-byte sector at F 7) and
//   staged through shared memory for whole-line stores; the radix sort
//   above moves the key and the slot word only (8 bytes an entry a pass,
//   not 4 + 4 F; the first pass takes each entry's index as its slot), on
//   9-bit digits of the row's low bits that tell one level's rows apart
//   (two passes at 2^17 rows a level): a stable sort keeps two levels' rows
//   with the same low bits apart, in level order, so each row's entries
//   lie together in ascending e, and the sum tells rows apart by the whole
//   key. row_sum_any_kernel then sums a feature group: a warp reads a
//   batch of sorted keys and slots whole-line and the entries' values (a
//   sector each) through the slots into shared memory, all in flight
//   together; each lane adds the runs that start at its positions from
//   shared memory, a long run's lane following it batch after batch (not
//   a chain of dependent loads from device memory), and a finished row goes
//   out as one store of F lanes. The launcher reports the route: 0 the instances ("fixed"), 1 the
//   any kernels ("any").
//
// Past 2^31 - 1 entries, or where the scratch would pass kScratchCap, the
// launcher cuts the samples into ranges (range_samples), each run as a call
// of its own whose row sums start from what the ranges before left in grad
// (Feat::acc; +0 where none): the entries of a later range follow those of
// an earlier one in e, so the bits are one launch's.
//
// What bounds it on an H100: bytes. The entries route reads and writes a key
// and F values per entry once per pass. The runs route writes each entry's
// values once and reads them once; what it sorts is a descriptor per run (7
// times fewer than entries at nerfacto's first proposal grid), and its chunk
// sort stays in shared memory. A dense level's row can hold thousands of
// entries, whose sum is one chain of dependent adds.
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "hash_grid.cuh"

namespace {

constexpr int kThreads = 256;  // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;  // the chunk sort's and the entries route's digits
constexpr int kDigits = 1 << kDigitBits;
constexpr int kRunDigitBits = 9;  // the runs' sort: two passes for levels of 2^17 rows
constexpr int kRun = 8;  // consecutive sorted entries per lane in the sum
constexpr int kSumBatch = 32 * kRun;  // sorted entries per warp round of the sum
constexpr int kBlocksPerSm = 8;  // per SM, the grid of the kernels that walk their tiles
// The launch bounds that name a minimum of blocks per SM (1 or 2, the same
// register cap of 255 or 128): without one, ptxas gave those kernels 32-48
// registers and spilled, and digit_scatter_kernel ran 3% slower (H100).
constexpr int kFoldFloats = 512;  // staged values per warp in run_fold_kernel
constexpr uint32_t kSkip = 0xffffffffu;  // key of an entry that adds nothing
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kDigits, "one thread per digit in the scans");
using umhs::Levels;

// The levels one route takes, ascending.
struct LevelList {
  int count;
  int level[umhs::kMaxLevels];
};

// Entries per chunk of the runs route: the staged values take at most 16 KB
// of shared memory, the run starts fit the warp counters' 2,048 words, and
// a chunk is whole items of the block's 256 threads.
__host__ __device__ constexpr int chunk_entries(int F) {
  return F <= 2 ? 2048 : 4096 / F / kThreads * kThreads;
}

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

// The F gradients of one (sample, level), in one or two vector loads
// (float2 loads for another even F, a float at a time for an odd one, or
// everywhere without kVec: a row of the any route's g may start anywhere).
template <int F, bool kVec = true>
__device__ __forceinline__ void load_row(const float* p, float (&v)[F]) {
  if constexpr (F == 1 || !kVec || F % 2 != 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = __ldg(p + f);
  } else if constexpr (F % 4 != 0) {
#pragma unroll
    for (int i = 0; i < F / 2; ++i) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(p) + i);
      v[2 * i] = a.x;
      v[2 * i + 1] = a.y;
    }
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

// One table row's F sums, in one or two vector stores (as load_row).
template <int F>
__device__ __forceinline__ void store_row(float* p, const float (&v)[F]) {
  if constexpr (F == 1 || F % 2 != 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) p[f] = v[f];
  } else if constexpr (F % 4 != 0) {
#pragma unroll
    for (int i = 0; i < F / 2; ++i)
      reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
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

// The row of one (sample, level) of the stochastic mode: the first vertex
// whose running weight sum exceeds u_l, else the last.
template <int V>
__device__ __forceinline__ uint32_t drawn_row(const uint32_t (&rows)[V], const float (&w)[V],
                                              float ul) {
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
  return row;
}

// The levels as a kernel reads them: by value (`Levels`, the template
// instances of F 1, 2, 4, 8 at up to 32 levels) or from the wrapper's device
// table (`LevelTable`, the any route). A kernel on the table reads its g and
// writes its gradient a float at a time (kVec false).
struct LevelTable {
  const umhs::LevelArg* table;
  uint32_t hash_mask;
};

template <bool kTetra>
__device__ __forceinline__ void vertices(const float p[3], int l, const Levels& lv,
                                         uint32_t (&rows)[kTetra ? 4 : 8],
                                         float (&w)[kTetra ? 4 : 8]) {
  umhs::hash_vertices<kTetra>(p, l, lv, rows, w);
}
template <bool kTetra>
__device__ __forceinline__ void vertices(const float p[3], int l, const LevelTable& lt,
                                         uint32_t (&rows)[kTetra ? 4 : 8],
                                         float (&w)[kTetra ? 4 : 8]) {
  umhs::hash_vertices<kTetra>(p, umhs::level_arg(lt.table, l), lt.hash_mask, rows, w);
}

// Row offset and rows of a level of the table.
__device__ __forceinline__ uint32_t level_offset(const Levels& lv, int l) {
  return static_cast<uint32_t>(lv.offset[l]);
}
__device__ __forceinline__ uint32_t level_offset(const LevelTable& lt, int l) {
  return static_cast<uint32_t>(umhs::level_arg(lt.table, l).offset);
}
__device__ __forceinline__ uint32_t level_rows(const Levels& lv, int l) {
  const uint32_t r = static_cast<uint32_t>(lv.res[l]);
  return lv.dense[l] ? r * r * r : lv.hash_mask + 1u;
}
__device__ __forceinline__ uint32_t level_rows(const LevelTable& lt, int l) {
  const umhs::LevelArg a = umhs::level_arg(lt.table, l);
  const uint32_t r = static_cast<uint32_t>(a.res);
  return a.dense ? r * r * r : lt.hash_mask + 1u;
}

template <class LS>
constexpr bool kByValue = std::is_same<LS, Levels>::value;

// Where a kernel's features lie: the table row and a (sample, level)'s g
// row are `stride` floats (the grid's F), the kernel takes features [f0, f0
// + its F) (a group of at most 8 on the any route), and with acc each row's
// sum goes on from what earlier sample ranges left in grad (+0 where none).
struct Feat {
  int stride, f0, acc;
};

// The any route's values: each entry's F floats padded to P = round4(F), so
// that its sum reads them as float4 loads (one 32-byte sector at F 7).
__host__ __device__ constexpr int padded_width(int F) { return (F + 3) / 4 * 4; }

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

// The lanes of the warp that hold the same digit d (of kBits bits) and are
// valid.
template <int kBits>
__device__ __forceinline__ unsigned digit_peers(uint32_t d, bool valid) {
  unsigned peers = __ballot_sync(kFull, valid);
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned set = __ballot_sync(kFull, bit);
    peers &= bit ? set : ~set;
  }
  return peers;
}

// --------------------------------------------------------------- route "runs"

// One stable pass of the chunk sort in shared memory: the first m (key,
// order) pairs placed by digit ((key - off) >> shift) & 255, kSkip keys
// dropped; returns how many were placed. Warp w takes positions
// w * 32 * kItems + j * 32 + lane in order and ranks each among the warp's
// earlier pairs of its digit, as digit_scatter_kernel does, its peers found
// by __match_any_sync (faster here than digit_peers' ballots; slower in the
// global sort, measured on an H100). Every thread of the block calls it.
template <int kItems>
__device__ __forceinline__ uint32_t chunk_sort_pass(uint32_t* keys, uint16_t* order, uint32_t m,
                                                uint32_t off, int shift,
                                                uint32_t (*warp_count)[kDigits],
                                                uint32_t* digit_start) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_count[w][t] = 0;
  __syncthreads();
  const uint32_t base = warp * (32 * kItems) + lane;
  uint32_t key[kItems], rank[kItems];
  uint16_t ord[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const uint32_t at = base + 32 * j;
    key[j] = at < m ? keys[at] : kSkip;
    const bool valid = key[j] != kSkip;
    ord[j] = valid ? order[at] : 0;
    const uint32_t d = ((key[j] - off) >> shift) & (kDigits - 1);
    const unsigned peers = __match_any_sync(kFull, valid ? d : kDigits + lane);
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
  uint32_t total;
  digit_start[t] = block_exclusive_scan(run, &total);  // syncs: warp_count is complete
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (rank[j] == kSkip) continue;
    const uint32_t d = ((key[j] - off) >> shift) & (kDigits - 1);
    const uint32_t at = digit_start[d] + warp_count[warp][d] + rank[j];
    keys[at] = key[j];
    order[at] = ord[j];
  }
  __syncthreads();
  return total;
}

// 1. A block per (chunk, level of the route): the chunk's nonzero entries
// sorted by row in shared memory, their values written in that order into
// the chunk's slots [chunk * E, chunk * E + m) of vals, and one descriptor
// per run into the chunk's slots of run_rows and run_spans (the run's slots
// [start, end) of vals); run_count[chunk] = its runs. Chunks are numbered
// level-major: chunk = i * chunks + c for the route's i-th level.
template <int F, bool kTetra, bool kStochastic, class LS>
__global__ void __launch_bounds__(kThreads)
run_emit_kernel(const float* __restrict__ pos, const float* __restrict__ g, uint32_t n, int L,
                LS lv, LevelList list, uint32_t chunks, Feat ft, float* __restrict__ vals,
                uint32_t* __restrict__ run_rows, uint2* __restrict__ run_spans,
                uint32_t* __restrict__ run_count) {
  constexpr int V = kTetra ? 4 : 8;
  constexpr int VE = kStochastic ? 1 : V;
  constexpr int E = chunk_entries(F);
  constexpr int C = E / VE;  // samples per chunk
  constexpr int kItems = E / kThreads;
  static_assert(E <= kWarps * kDigits, "the run starts reuse warp_count");
  __shared__ uint32_t keys[E];
  __shared__ uint16_t order[E];
  __shared__ __align__(16) float staged[E * F];
  __shared__ uint32_t warp_count[kWarps][kDigits];
  __shared__ uint32_t digit_start[kDigits];
  const int t = threadIdx.x;
  const int l = list.level[blockIdx.y];
  const size_t chunk = static_cast<size_t>(blockIdx.y) * chunks + blockIdx.x;
  const uint32_t first = blockIdx.x * static_cast<uint32_t>(C);

  // the chunk's entries in ascending e: slot j = (s - first) * VE + v holds
  // the row (kSkip when its values are all zero, or past n) and the values
  for (uint32_t local = t; local < static_cast<uint32_t>(C); local += kThreads) {
    const uint32_t s = first + local;
    uint32_t* key = keys + local * VE;
    if (s >= n) {
#pragma unroll
      for (int v = 0; v < VE; ++v) key[v] = kSkip;
      continue;
    }
    const float p[3] = {__ldg(pos + 3 * s), __ldg(pos + 3 * s + 1), __ldg(pos + 3 * s + 2)};
    uint32_t rows[V];
    float w[V];
    vertices<kTetra>(p, l, lv, rows, w);
    float gv[F];
    load_row<F, kByValue<LS>>(g + (static_cast<size_t>(s) * L + l) * ft.stride + ft.f0, gv);
    if (kStochastic) {
      const uint32_t r = drawn_row<V>(rows, w, level_uniform(position_uniform(p), l));
      key[0] = all_zero<F>(gv) ? kSkip : r;
      store_row<F>(staged + local * F, gv);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float c[F];
#pragma unroll
        for (int f = 0; f < F; ++f) c[f] = __fmul_rn(w[v], gv[f]);
        key[v] = all_zero<F>(c) ? kSkip : rows[v];
        store_row<F>(staged + (local * VE + v) * F, c);
      }
    }
  }
  for (int j = t; j < E; j += kThreads) order[j] = static_cast<uint16_t>(j);
  __syncthreads();

  // stable sort by the low 16 bits of the level-local row (8 when the level
  // has at most 256 rows); the first pass drops the kSkip entries, leaving m
  const uint32_t off = level_offset(lv, l);
  const int bits = level_rows(lv, l) > static_cast<uint32_t>(kDigits) ? 2 * kDigitBits : kDigitBits;
  uint32_t m = E;
  for (int shift = 0; shift < bits; shift += kDigitBits)
    m = chunk_sort_pass<kItems>(keys, order, m, off, shift, warp_count, digit_start);

  // the runs: thread t counts the run starts among sorted positions
  // [t * kItems, t * kItems + kItems) and records them in order
  uint32_t heads = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t p = t * kItems + k;
    heads += p < m && (p == 0 || keys[p] != keys[p - 1]);
  }
  uint32_t runs;
  uint32_t r = block_exclusive_scan(heads, &runs);
  uint32_t* head_at = &warp_count[0][0];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const uint32_t p = t * kItems + k;
    if (p < m && (p == 0 || keys[p] != keys[p - 1])) head_at[r++] = p;
  }
  __syncthreads();
  const size_t slot0 = chunk * E;
  for (uint32_t q = t; q < runs; q += kThreads) {
    const uint32_t p = head_at[q], end = q + 1 < runs ? head_at[q + 1] : m;
    run_rows[slot0 + q] = keys[p];
    run_spans[slot0 + q] = make_uint2(static_cast<uint32_t>(slot0 + p),
                                      static_cast<uint32_t>(slot0 + end));
  }
  if (t == 0) run_count[chunk] = runs;
  for (uint32_t p = t; p < m; p += kThreads) {
    float v[F];
    const uint32_t o = order[p];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = staged[o * F + f];
    store_row<F>(vals + (slot0 + p) * F, v);
  }
}

// 2a. The chunks' descriptors packed in chunk order, a warp a chunk: chunk
// c's runs go to [offsets[c], offsets[c + 1]) (offsets: the exclusive scan
// of the run counts; *total: all of them).
__global__ void __launch_bounds__(kThreads)
compact_runs_kernel(const uint32_t* __restrict__ rows_in, const uint2* __restrict__ spans_in,
                    const uint32_t* __restrict__ offsets, const uint32_t* __restrict__ total,
                    uint32_t chunks, uint32_t chunk_slots, uint32_t* __restrict__ rows_out,
                    uint2* __restrict__ spans_out) {
  const uint32_t c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= chunks) return;
  const uint32_t begin = offsets[c], end = c + 1 < chunks ? offsets[c + 1] : *total;
  const size_t slot0 = static_cast<size_t>(c) * chunk_slots;
  for (uint32_t q = threadIdx.x & 31; q < end - begin; q += 32) {
    rows_out[begin + q] = rows_in[slot0 + q];
    spans_out[begin + q] = spans_in[slot0 + q];
  }
}

// 3. Warp w of the grid's walk owns sorted descriptors [32 w, 32 w + 32) and
// folds each row whose first run lies there, 32 aligned descriptors (a
// group) at a time, the next group's rows and spans loaded while this one's
// values are folded. A group's runs of the row, laid end to end, are read
// kPer entries a lane per window (each lane finds its entries' runs by a
// binary search over the runs' places) into the warp's shared buffer, one
// feature after another, and padded with +0 to a multiple of 4 entries
// (adding +0 to a sum that started at +0 changes no bit); the next window's
// loads are in flight while lanes 0..F-1 each add one feature's entries,
// four per shared load, from +0 in order, one __fadd_rn each.
template <int F>
__global__ void __launch_bounds__(kThreads, 2)
run_fold_kernel(const uint32_t* __restrict__ rows, const uint2* __restrict__ spans,
                const uint32_t* __restrict__ count, const float* __restrict__ vals,
                float* __restrict__ grad, Feat ft) {
  constexpr int kPer = kFoldFloats / F / 32;  // entries per lane in a window
  constexpr uint32_t kCap = 32 * kPer;  // entries per window
  __shared__ __align__(16) float staged[kWarps][kFoldFloats];
  __shared__ uint32_t place[kWarps][32];  // where each lane's run starts in the row's group
  __shared__ uint32_t source[kWarps][32];  // and in vals
  const uint32_t live = *count;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* buf = staged[warp];
  const uint32_t warps = gridDim.x * kWarps;
  for (uint32_t w = blockIdx.x * kWarps + warp; static_cast<uint64_t>(w) * 32 < live; w += warps) {
    const uint32_t i = w * 32 + lane;
    const uint32_t mine = i < live ? rows[i] : kSkip;
    const uint2 my_span = i < live ? spans[i] : make_uint2(0u, 0u);
    uint32_t prev = __shfl_up_sync(kFull, mine, 1);
    if (lane == 0) prev = w > 0 ? rows[w * 32 - 1] : kSkip;
    unsigned heads = __ballot_sync(kFull, i < live && mine != prev);
    while (heads) {
      const int h = __ffs(heads) - 1;
      heads &= heads - 1;
      const uint32_t row = __shfl_sync(kFull, mine, h);
      // lane f < F: the row's sum of feature f
      float mine_acc = ft.acc && lane < F
                           ? grad[static_cast<size_t>(row) * ft.stride + ft.f0 + lane] : 0.f;
      uint32_t group = w * 32, g_row = mine;
      uint2 span = my_span;
      int first = h;
      while (true) {
        const bool in = lane >= first && g_row == row;  // a row's runs lie together
        const bool more = __shfl_sync(kFull, in, 31) && group + 32 < live;
        uint32_t n_row = kSkip;  // the next group, in flight while this one is folded
        uint2 n_span = make_uint2(0u, 0u);
        if (more) {
          const uint32_t k = group + 32 + lane;
          n_row = k < live ? rows[k] : kSkip;
          n_span = k < live ? spans[k] : make_uint2(0u, 0u);
        }
        const uint32_t len = in ? span.y - span.x : 0u;
        uint32_t incl = len;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const uint32_t y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        const uint32_t total = __shfl_sync(kFull, incl, 31);
        place[warp][lane] = incl - len;
        source[warp][lane] = span.x;
        __syncwarp();
        // entry e of the group lies in the run of the last lane whose place <= e
        float v[kPer][F];
        auto load = [&](uint32_t lo) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const uint32_t e = lo + q * 32 + lane;
            if (e >= total) continue;
            int k = 0;
#pragma unroll
            for (int step = 16; step > 0; step >>= 1)
              if (place[warp][k + step] <= e) k += step;
            load_row<F>(vals + (static_cast<size_t>(source[warp][k]) + (e - place[warp][k])) * F,
                        v[q]);
          }
        };
        load(0);
        for (uint32_t lo = 0; lo < total; lo += kCap) {
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const bool real = lo + q * 32 + lane < total;
#pragma unroll
            for (int f = 0; f < F; ++f) buf[f * kCap + q * 32 + lane] = real ? v[q][f] : 0.f;
          }
          __syncwarp();
          if (lo + kCap < total) load(lo + kCap);
          if (lane < F) {
            const uint32_t cnt = total - lo < kCap ? total - lo : kCap;
            const float4* x = reinterpret_cast<const float4*>(buf + lane * kCap);
#pragma unroll 4
            for (uint32_t c = 0; c < (cnt + 3) / 4; ++c) {
              const float4 y = x[c];
              mine_acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(mine_acc, y.x), y.y), y.z), y.w);
            }
          }
          __syncwarp();
        }
        if (!more) break;
        group += 32;
        g_row = n_row;
        span = n_span;
        first = 0;
      }
      if (lane < F) grad[static_cast<size_t>(row) * ft.stride + ft.f0 + lane] = mine_acc;
    }
  }
}

// ------------------------------------------------------------ route "entries"

// 1. One thread per sample: every entry of the route's levels, key and
// values into its slot.
template <int F, bool kTetra, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
emit_kernel(const float* __restrict__ pos, const float* __restrict__ g, uint32_t* __restrict__ keys,
            float* __restrict__ vals, uint32_t n, int L, Levels lv, LevelList list) {
  const uint32_t s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const float p[3] = {__ldg(pos + 3 * s), __ldg(pos + 3 * s + 1), __ldg(pos + 3 * s + 2)};
  const float u = kStochastic ? position_uniform(p) : 0.f;
  const float* gs = g + static_cast<size_t>(s) * L * F;  // g[s, l * F + f]
  constexpr int V = kTetra ? 4 : 8;
  constexpr int VE = kStochastic ? 1 : V;
  for (int i = 0; i < list.count; ++i) {
    const int l = list.level[i];
    uint32_t rows[V];
    float w[V];
    umhs::hash_vertices<kTetra>(p, l, lv, rows, w);
    float gv[F];
    load_row<F>(gs + l * F, gv);
    const size_t k = (static_cast<size_t>(i) * n + s) * VE;
    if (kStochastic) {
      const uint32_t row = drawn_row<V>(rows, w, level_uniform(u, l));
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

// Entries per lane in a sort tile: the staged tile's keys and values fit
// 48 KB of shared memory beside the counters.
__host__ __device__ constexpr int sort_items(int F) {
  return F == 1 ? 16 : (F == 2 ? 8 : 4);
}

__device__ __forceinline__ uint32_t tiles_of(uint32_t live, uint32_t tile) {
  return static_cast<uint32_t>((static_cast<uint64_t>(live) + tile - 1) / tile);
}

// 2a. Digit counts of each tile: counts[d * stride + tile], digits of kBits
// bits. The live entries are the first *live_in (m where live_in is null);
// kSkip keys are not counted. The blocks walk the live tiles.
template <int kItems, int kBits>
__global__ void __launch_bounds__(kThreads)
digit_count_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ live_in,
                   uint32_t m, int shift, uint32_t* __restrict__ counts, uint32_t stride) {
  constexpr int kTile = kThreads * kItems;
  constexpr int kD = 1 << kBits;
  __shared__ uint32_t hist[kD];
  const uint32_t live = live_in ? *live_in : m;
  const uint32_t tiles = tiles_of(live, kTile);
  for (uint32_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int d = threadIdx.x; d < kD; d += kThreads) hist[d] = 0;
    __syncthreads();
    const size_t base = static_cast<size_t>(tile) * kTile;
#pragma unroll 4
    for (int i = 0; i < kItems; ++i) {
      const size_t idx = base + static_cast<size_t>(i) * kThreads + threadIdx.x;
      if (idx >= live) break;
      const uint32_t key = keys[idx];
      if (key != kSkip) atomicAdd(&hist[(key >> shift) & (kD - 1)], 1u);
    }
    __syncthreads();
#pragma unroll
    for (int d = threadIdx.x; d < kD; d += kThreads)
      counts[static_cast<size_t>(d) * stride + tile] = hist[d];
    __syncthreads();  // hist is zeroed again
  }
}

// 2b. One block per digit d: counts[d * stride + tile] over the live tiles
// (ceil(live / per_tile) of them, live = *live_in or m) turned into
// exclusive prefixes in place; totals[d] = the digit's count. The counts
// pass through shared memory kScanItems a thread at a time: loaded and
// stored coalesced, scanned a consecutive stretch per thread (the index
// padded by one word in 32, so that the stretches fall in distinct banks).
constexpr int kScanItems = 16;
__device__ __forceinline__ int scan_pad(int j) { return j + (j >> 5); }

__global__ void __launch_bounds__(kThreads)
digit_scan_kernel(uint32_t* __restrict__ counts, uint32_t stride,
                  const uint32_t* __restrict__ live_in, uint32_t m, uint32_t per_tile,
                  uint32_t* __restrict__ totals) {
  constexpr int kChunk = kThreads * kScanItems;
  __shared__ uint32_t s[kChunk + kChunk / 32];
  const int t = threadIdx.x;
  const uint32_t tiles = tiles_of(live_in ? *live_in : m, per_tile);
  uint32_t* c = counts + static_cast<size_t>(blockIdx.x) * stride;
  uint32_t carry = 0;
  for (uint32_t base = 0; base < tiles; base += kChunk) {
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int j = q * kThreads + t;
      s[scan_pad(j)] = base + j < tiles ? c[base + j] : 0u;
    }
    __syncthreads();
    uint32_t sum = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) sum += s[scan_pad(t * kScanItems + q)];
    uint32_t chunk;
    uint32_t run = carry + block_exclusive_scan(sum, &chunk);
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int j = scan_pad(t * kScanItems + q);
      const uint32_t v = s[j];
      s[j] = run;
      run += v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int j = q * kThreads + t;
      if (base + j < tiles) c[base + j] = s[scan_pad(j)];
    }
    carry += chunk;
    __syncthreads();  // s is loaded again
  }
  if (t == 0) totals[blockIdx.x] = carry;
}

// 2c. Stable placement of one tile's entries (key and F words) by their
// digit of kBits bits; thread t owns digits t * kPer .. t * kPer + kPer - 1
// (kPer = 2^kBits / kThreads) and gets their starts from the totals in
// digit_start. Warp w takes the tile's entries w * 32 * kItems + j * 32 + lane,
// j = 0..kItems-1, in index order, and ranks each among the warp's earlier
// entries of its digit (ballots over the digit's bits). The tile is then
// laid out in shared memory in digit order and written out a digit run at a
// time, so that neighbouring lanes store to neighbouring addresses. The
// first pass drops kSkip keys. Every thread of the block calls it.
template <int F, bool kFirst, int kBits>
__device__ __forceinline__ void scatter_tile(const uint32_t* __restrict__ keys_in,
                                             const float* __restrict__ vals_in,
                                             uint32_t* __restrict__ keys_out,
                                             float* __restrict__ vals_out, size_t first,
                                             uint32_t in_tile_live, int shift,
                                             const uint32_t* __restrict__ counts,
                                             uint32_t stride, uint32_t tile,
                                             const uint32_t (&digit_start)[(1 << kBits) /
                                                                           kThreads]) {
  constexpr int kItems = sort_items(F);
  constexpr int kTile = kThreads * kItems;
  constexpr int kD = 1 << kBits, kPer = kD / kThreads;
  __shared__ uint32_t start[kD];  // where this tile's entries of digit d go in the output
  __shared__ uint32_t local[kD];  // where they go in the staged tile
  __shared__ uint16_t warp_count[kWarps][kD];  // at most kTile
  __shared__ uint32_t staged_keys[kTile];
  __shared__ __align__(16) float staged_vals[kTile * F];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = t * kPer + i;
    start[d] = digit_start[i] + counts[static_cast<size_t>(d) * stride + tile];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_count[w][d] = 0;
  }
  __syncthreads();

  const unsigned below = (1u << lane) - 1u;
  const uint32_t mine = warp * (32 * kItems) + lane;  // the warp's entries in the tile
  const size_t base = first + mine;
  uint32_t key[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const size_t idx = base + 32 * j;
    bool valid = mine + 32 * j < in_tile_live;
    key[j] = valid ? keys_in[idx] : kSkip;
    if (kFirst) valid = valid && key[j] != kSkip;
    const uint32_t d = (key[j] >> shift) & (kD - 1);
    const unsigned peers = digit_peers<kBits>(d, valid);
    rank[j] = valid ? warp_count[warp][d] + __popc(peers & below) : kSkip;
    __syncwarp();
    if (valid && (peers & below) == 0u) warp_count[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  uint32_t runs[kPer], sum = 0;  // thread t's digits' counts over the warps -> prefixes
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_count[w][t * kPer + i];
      warp_count[w][t * kPer + i] = run;
      run += c;
    }
    runs[i] = run;
    sum += run;
  }
  uint32_t in_tile;
  uint32_t before = block_exclusive_scan(sum, &in_tile);  // syncs: warp_count is complete
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    local[t * kPer + i] = before;
    before += runs[i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (rank[j] == kSkip) continue;
    const uint32_t d = (key[j] >> shift) & (kD - 1);
    const uint32_t at = local[d] + warp_count[warp][d] + rank[j];
    staged_keys[at] = key[j];
    float v[F];
    if (vals_in != nullptr) {
      load_row<F>(vals_in + (base + 32 * j) * F, v);
    } else {  // the any route's first pass: each entry's word is its index (its slot)
      v[0] = __uint_as_float(static_cast<uint32_t>(base + 32 * j));
    }
    store_row<F>(staged_vals + static_cast<size_t>(at) * F, v);
  }
  __syncthreads();
  for (uint32_t i = t; i < in_tile; i += kThreads) {
    const uint32_t k = staged_keys[i];
    const uint32_t d = (k >> shift) & (kD - 1);
    const size_t at = start[d] + (i - local[d]);
    keys_out[at] = k;
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = staged_vals[i * F + f];
    store_row<F>(vals_out + at * F, v);
  }
}

// Where each digit of thread t's kPer starts in the output, from the
// digits' totals (thread t owns digits t * kPer ..); *total: all of them.
template <int kBits>
__device__ __forceinline__ void digit_starts(const uint32_t* __restrict__ totals,
                                             uint32_t (&starts)[(1 << kBits) / kThreads],
                                             uint32_t* total) {
  constexpr int kPer = (1 << kBits) / kThreads;
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) sum += totals[threadIdx.x * kPer + i];
  uint32_t before = block_exclusive_scan(sum, total);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    starts[i] = before;
    before += totals[threadIdx.x * kPer + i];
  }
}

// The placement of a pass on digits of kBits bits, one tile a block (the
// grid sized to the tiles; the entries route, 8-bit digits; the any route,
// 9-bit). Each block scans the digit totals for the digits' starts; the
// first pass's block 0 writes the live count (its kSkip keys dropped).
template <int F, bool kFirst, int kBits>
__global__ void __launch_bounds__(kThreads, 1)
digit_scatter_kernel(const uint32_t* __restrict__ keys_in, const float* __restrict__ vals_in,
                     uint32_t* __restrict__ keys_out, float* __restrict__ vals_out,
                     const uint32_t* __restrict__ live_in, uint32_t m,
                     uint32_t* __restrict__ count, int shift,
                     const uint32_t* __restrict__ counts, uint32_t stride,
                     const uint32_t* __restrict__ totals) {
  uint32_t total, starts[(1 << kBits) / kThreads];
  digit_starts<kBits>(totals, starts, &total);
  if (kFirst && blockIdx.x == 0 && threadIdx.x == 0) *count = total;
  constexpr uint32_t kTile = kThreads * sort_items(F);
  const uint32_t live = live_in ? *live_in : m;
  const size_t first = static_cast<size_t>(blockIdx.x) * kTile;
  if (first < live)
    scatter_tile<F, kFirst, kBits>(
        keys_in, vals_in, keys_out, vals_out, first,
        live - first < kTile ? static_cast<uint32_t>(live - first) : kTile, shift, counts, stride,
        blockIdx.x, starts);
}

// The same on digits of kBits bits where the blocks (a grid of at most
// grid_cap) walk the live tiles: the runs route, whose count lives on the card.
template <int F, bool kFirst, int kBits>
__global__ void __launch_bounds__(kThreads, 2)
digit_scatter_walk_kernel(const uint32_t* __restrict__ keys_in, const float* __restrict__ vals_in,
                          uint32_t* __restrict__ keys_out, float* __restrict__ vals_out,
                          const uint32_t* __restrict__ live_in, uint32_t m,
                          uint32_t* __restrict__ count, int shift,
                          const uint32_t* __restrict__ counts, uint32_t stride,
                          const uint32_t* __restrict__ totals) {
  constexpr uint32_t kTile = kThreads * sort_items(F);
  uint32_t total, starts[(1 << kBits) / kThreads];
  digit_starts<kBits>(totals, starts, &total);
  if (kFirst && blockIdx.x == 0 && threadIdx.x == 0) *count = total;
  const uint32_t live = live_in ? *live_in : m;
  const uint32_t tiles = tiles_of(live, kTile);
  for (uint32_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t first = static_cast<size_t>(tile) * kTile;
    const uint32_t in_tile = live - first < kTile ? static_cast<uint32_t>(live - first) : kTile;
    scatter_tile<F, kFirst, kBits>(keys_in, vals_in, keys_out, vals_out, first, in_tile, shift,
                                   counts, stride, tile, starts);
    __syncthreads();  // the shared arrays serve the next tile
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
               const uint32_t* __restrict__ count, float* __restrict__ grad, Feat ft) {
  auto row_at = [&](uint32_t row) { return grad + static_cast<size_t>(row) * F; };
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
          if (tail_row != kSkip) store_row<F>(row_at(tail_row), tail);
          tail_row = kk[c];
#pragma unroll
          for (int f = 0; f < F; ++f)
            tail[f] = ft.acc && tail_row != kSkip ? row_at(tail_row)[f] : 0.f;
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
          if (in_owned && in_row != kSkip) store_row<F>(row_at(in_row), in);
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
  if (lane == 0) store_row<F>(row_at(carry_row), carry);
}

// 3. The any route's sum: a warp takes kAnyBatch sorted entries, reads
// their keys and slot words whole-line, then their values through the
// slots into shared memory (features [f0, f0 + F) of a row padded to
// padded_width(stride) floats: one sector an entry at F <= 8), and each
// lane sums the runs that start at its positions (e = 32 q + lane), from
// shared memory, feature by feature in ascending entry order from +0 (or
// from grad with acc). A finished run's sums go to shared memory at its
// head's position, and the warp stores them a row to F lanes, so that a
// row is one store. The run that reaches the batch's end and goes on past
// it is followed by the warp: batch after batch, its lane adds on until
// its row ends. A run that starts before the batch is its starter's.
constexpr int kAnyBatch = 128;  // sorted entries a warp takes at a time
constexpr int kAnyWarps = 4;    // warps a block

// Adds the staged entries [e, end), all of one row, onto sums, feature by
// feature in order.
template <int F, int kP4>
__device__ __forceinline__ void add_staged(float (&sums)[F], const float4 (*vals)[kP4], int e,
                                           int end) {
  for (; e < end; ++e) {
#pragma unroll
    for (int h = 0; h < kP4; ++h) {
      const float4 v = vals[e][h];
      if (4 * h < F) sums[4 * h] = __fadd_rn(sums[4 * h], v.x);
      if (4 * h + 1 < F) sums[4 * h + 1] = __fadd_rn(sums[4 * h + 1], v.y);
      if (4 * h + 2 < F) sums[4 * h + 2] = __fadd_rn(sums[4 * h + 2], v.z);
      if (4 * h + 3 < F) sums[4 * h + 3] = __fadd_rn(sums[4 * h + 3], v.w);
    }
  }
}

template <int F>
__global__ void __launch_bounds__(32 * kAnyWarps)
row_sum_any_kernel(const uint32_t* __restrict__ keys, const float* __restrict__ slots,
                   const uint32_t* __restrict__ count, uint32_t m,
                   const float* __restrict__ vals, float* __restrict__ grad, Feat ft) {
  constexpr int kP4 = (F + 3) / 4;  // float4 pieces of an entry's features
  constexpr int kQ = kAnyBatch / 32;
  __shared__ uint32_t s_key[kAnyWarps][kAnyBatch];
  __shared__ uint32_t s_slot[kAnyWarps][kAnyBatch];
  __shared__ float4 s_val[kAnyWarps][kAnyBatch][kP4];
  __shared__ float s_res[kAnyWarps][kAnyBatch + 1][F];  // a run's sums at its head
  __shared__ uint32_t s_row[kAnyWarps][kAnyBatch + 1];  // its row, or kSkip
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const size_t first = (static_cast<size_t>(blockIdx.x) * kAnyWarps + wi) * kAnyBatch;
  if (first >= m) return;  // uniform across the warp
  const int P = padded_width(ft.stride);
  uint32_t* key = s_key[wi];
  auto row_at = [&](uint32_t row) { return grad + static_cast<size_t>(row) * ft.stride + ft.f0; };
  // the batch at `at`: keys and slots into shared memory (the buffers hold m
  // words, the first `live` sorted; keys past live become kSkip), and the
  // keys just before and just after the batch, all in one round of loads
  // with the live count's
  uint32_t live = 0, before = kSkip, after = kSkip;
  auto load_keys = [&](size_t at, bool first_round) {
    uint32_t k[kQ], sl[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const size_t i = at + q * 32 + lane;
      k[q] = i < m ? keys[i] : kSkip;
      sl[q] = i < m ? __float_as_uint(slots[i]) : 0u;
    }
    uint32_t b = kSkip, a = kSkip, c = 0;
    if (lane == 0) {
      if (first_round) c = *count;
      if (first_round && at > 0) b = keys[at - 1];
      if (at + kAnyBatch < m) a = keys[at + kAnyBatch];
    }
    if (first_round) live = __shfl_sync(kFull, c, 0);
    before = __shfl_sync(kFull, b, 0);
    after = at + kAnyBatch < live ? __shfl_sync(kFull, a, 0) : kSkip;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      key[q * 32 + lane] = at + q * 32 + lane < live ? k[q] : kSkip;
      s_slot[wi][q * 32 + lane] = sl[q];
    }
    __syncwarp();
  };
  // the values of the batch's entries [lo, hi) (those below live)
  auto load_vals = [&](size_t at, int lo, int hi) {
#pragma unroll
    for (int q = 0; q < kQ * kP4; ++q) {
      const int idx = q * 32 + lane, e = idx / kP4, h = idx - e * kP4;
      if (e >= lo && e < hi && at + e < live)
        s_val[wi][e][h] = __ldg(reinterpret_cast<const float4*>(
                                    vals + static_cast<size_t>(s_slot[wi][e]) * P + ft.f0) + h);
    }
    __syncwarp();
  };
  // the rows the batch finished, a row to F lanes of one store
  auto store = [&]() {
    __syncwarp();
    for (int t = lane; t < (kAnyBatch + 1) * 8; t += 32) {
      const int e = t >> 3, f = t & 7;
      const uint32_t row = s_row[wi][e];
      if (f < F && row != kSkip) row_at(row)[f] = s_res[wi][e][f];
    }
    __syncwarp();
  };

  load_keys(first, true);
  if (first >= live) return;  // uniform across the warp
  const uint32_t prev = before;
  int lo = 0;  // the entries of the run begun before the batch are its starter's
  while (lo < kAnyBatch && key[lo] == prev) ++lo;
  load_vals(first, lo, kAnyBatch);
  const size_t next_at = first + kAnyBatch;
  // the run that goes on past the batch parks its sums at slot kAnyBatch
  // of s_res, its row in s_carry (s_row's slot kAnyBatch stays kSkip)
  __shared__ uint32_t s_carry[kAnyWarps];
  if (lane == 0) {
    s_row[wi][kAnyBatch] = kSkip;
    s_carry[wi] = kSkip;
  }
  __syncwarp();
#pragma unroll 1
  for (int q = 0; q < kQ; ++q) {
    const int e = q * 32 + lane;
    const uint32_t row = key[e];
    const bool head = row != kSkip && row != (e > 0 ? key[e - 1] : prev);
    s_row[wi][e] = kSkip;
    if (!head) continue;
    int end = e + 1;
    while (end < kAnyBatch && key[end] == row) ++end;
    float sums[F];
#pragma unroll
    for (int f = 0; f < F; ++f) sums[f] = ft.acc ? row_at(row)[f] : 0.f;
    add_staged<F, kP4>(sums, s_val[wi], e, end);
    const bool goes_on = end == kAnyBatch && after == row;
    if (goes_on) s_carry[wi] = row;
    else s_row[wi][e] = row;
#pragma unroll
    for (int f = 0; f < F; ++f) s_res[wi][goes_on ? kAnyBatch : e][f] = sums[f];
  }
  store();
  // follow the run that goes on past the batch, batch after batch (lane 0
  // adds; the other lanes load)
  const uint32_t row = s_carry[wi];
  if (row == kSkip) return;
  for (size_t at = next_at; at < live; at += kAnyBatch) {
    load_keys(at, false);
    int end = 0;
    while (end < kAnyBatch && key[end] == row) ++end;
    load_vals(at, 0, end);
    const bool more = end == kAnyBatch && after == row;
    if (lane == 0) {
      float sums[F];
#pragma unroll
      for (int f = 0; f < F; ++f) sums[f] = s_res[wi][kAnyBatch][f];
      add_staged<F, kP4>(sums, s_val[wi], 0, end);
#pragma unroll
      for (int f = 0; f < F; ++f) s_res[wi][kAnyBatch][f] = sums[f];
      if (!more) {
        s_row[wi][kAnyBatch] = row;  // only the followed row: the batch's others are its own warp's
        for (int e = 0; e < kAnyBatch; ++e) s_row[wi][e] = kSkip;
      }
    }
    if (!more) {
      store();
      return;
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------ any F, any L

// 1. A block per kEmitSamples consecutive samples at one level l0 +
// blockIdx.y, a thread a sample: its VE entries' keys and values, each
// entry's F values padded with zeros to P = padded_width(F) floats, at slot
// k = base + (blockIdx.y * n + s) * VE + v: the entries of a span of levels
// follow the spans before it, level-major. The block's values are one
// contiguous stretch: with `staged` each thread's VE * P floats go to
// shared memory at a stride of VE * P + 1 (distinct banks across a warp),
// and the block stores them as whole lines. No slot
// words: the sort's first pass takes each entry's index as its word.
constexpr int kEmitSamples = 128;

template <bool kTetra, bool kStochastic>
__global__ void __launch_bounds__(kEmitSamples)
emit_any_kernel(const float* __restrict__ pos, const float* __restrict__ g,
                uint32_t* __restrict__ keys, float* __restrict__ vals, uint32_t n, int L, int F,
                LevelTable lt, int l0, uint32_t base, int staged) {
  extern __shared__ float emit_tile[];  // kEmitSamples * (VE * P + 1) floats
  constexpr int V = kTetra ? 4 : 8;
  constexpr int VE = kStochastic ? 1 : V;
  const int P = padded_width(F), l = l0 + static_cast<int>(blockIdx.y);
  const int row_floats = VE * P, stride = staged ? row_floats + 1 : row_floats;
  const uint32_t s0 = blockIdx.x * kEmitSamples, s = s0 + threadIdx.x;
  const uint32_t count = min(static_cast<uint32_t>(kEmitSamples), n - s0);
  const size_t k0 = base + (static_cast<size_t>(blockIdx.y) * n + s0) * VE;  // the block's slots
  float* out = staged ? emit_tile + threadIdx.x * stride : vals + (k0 + threadIdx.x * VE) * P;
  if (s < n) {
    const float p[3] = {__ldg(pos + 3 * s), __ldg(pos + 3 * s + 1), __ldg(pos + 3 * s + 2)};
    uint32_t rows[V];
    float w[V];
    vertices<kTetra>(p, l, lt, rows, w);
    const float* gs = g + (static_cast<size_t>(s) * L + l) * F;
    uint32_t* kp = keys + k0 + threadIdx.x * VE;
    if (kStochastic) {
      bool zero = true;
      for (int f = 0; f < P; ++f) {
        const float v = f < F ? __ldg(gs + f) : 0.f;
        out[f] = v;
        zero = zero && v == 0.f;
      }
      kp[0] = zero ? kSkip : drawn_row<V>(rows, w, level_uniform(position_uniform(p), l));
    } else {
      unsigned nonzero = 0u;  // bit v: vertex v adds something
      for (int f = 0; f < P; ++f) {
        const float gv = f < F ? __ldg(gs + f) : 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float c = __fmul_rn(w[v], gv);
          out[v * P + f] = c;
          nonzero |= c != 0.f ? 1u << v : 0u;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) kp[v] = nonzero >> v & 1u ? rows[v] : kSkip;
    }
  }
  if (staged) {  // whole lines: a warp a thread's stretch at a time, or a float a thread
    __syncthreads();
    float* dst = vals + k0 * P;
    if (row_floats >= 32) {
      const int lane = threadIdx.x & 31;
      for (uint32_t t = threadIdx.x >> 5; t < count; t += kEmitSamples / 32)
        for (int j = lane; j < row_floats; j += 32) dst[t * row_floats + j] = emit_tile[t * stride + j];
    } else {
      for (uint32_t i = threadIdx.x; i < count * row_floats; i += kEmitSamples) {
        const uint32_t t = i / row_floats;
        dst[i] = emit_tile[t * stride + (i - t * row_floats)];
      }
    }
  }
}

// ------------------------------------------------------------------ launches

// LSD passes of digit_bits for keys below `rows`.
uint32_t sort_passes(uint64_t rows, int digit_bits) {
  uint32_t bits = 0;
  while (bits < 32 && ((rows - 1u) >> bits) != 0u) ++bits;
  return bits == 0 ? 1u : (bits + digit_bits - 1) / digit_bits;
}

size_t align256(size_t b) { return (b + 255) / 256 * 256; }

uint64_t ceil_div(uint64_t a, uint64_t b) { return (a + b - 1) / b; }

// Carves consecutive 256-aligned pieces out of the scratch (sizes only when
// the base is null).
struct Carver {
  char* base;
  size_t off = 0;
  template <typename T>
  T* take(uint64_t count) {
    T* at = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += align256(count * sizeof(T));
    return at;
  }
};

// The buffers of one stable radix sort of m keys, each with W 32-bit words:
// the keys and words twice, the digit counts, the digit totals, the live count.
struct SortBuffers {
  uint32_t *keys_a, *keys_b, *counts, *totals, *count;
  float *vals_a, *vals_b;
  uint32_t stride;  // tiles
};

SortBuffers sort_buffers(Carver& cv, uint64_t m, int W, int digit_bits) {
  SortBuffers s{};
  s.stride = static_cast<uint32_t>(ceil_div(m, kThreads * sort_items(W)));
  s.keys_a = cv.take<uint32_t>(m);
  s.keys_b = cv.take<uint32_t>(m);
  s.vals_a = cv.take<float>(m * W);
  s.vals_b = cv.take<float>(m * W);
  s.counts = cv.take<uint32_t>((1ull << digit_bits) * (s.stride > 0 ? s.stride : 1));
  s.totals = cv.take<uint32_t>(1ull << digit_bits);
  s.count = cv.take<uint32_t>(1);
  return s;
}

// The runs route's buffers: the values (chunk-major slots), the run counts
// of the chunks, their total, and the descriptors' sort (its b-buffers first
// hold the chunks' descriptor slots, its a-buffers the packed descriptors).
struct RunBuffers {
  float* vals;
  uint32_t *run_count, *run_total;
  SortBuffers sort;
};

struct RouteShape {
  uint32_t chunks;  // per level
  uint64_t slots;  // chunks of all the route's levels x chunk entries
};

RouteShape run_shape(uint64_t n, int levels, int F, int VE) {
  const uint64_t C = chunk_entries(F) / VE;
  const uint64_t chunks = ceil_div(n, C);
  return {static_cast<uint32_t>(chunks), chunks * levels * chunk_entries(F)};
}

RunBuffers run_buffers(Carver& cv, uint64_t n, int levels, int F, int VE) {
  const RouteShape rs = run_shape(n, levels, F, VE);
  RunBuffers b{};
  b.vals = cv.take<float>(rs.slots * F);
  b.run_count = cv.take<uint32_t>(static_cast<uint64_t>(rs.chunks) * levels);
  b.run_total = cv.take<uint32_t>(1);
  b.sort = sort_buffers(cv, rs.slots, 2, kRunDigitBits);
  return b;
}

// The placement kernel of a pass (only the one that runs is instantiated).
template <int W, int kBits, bool kWalk, bool kFirst>
constexpr auto scatter_of() {
  if constexpr (kWalk) {
    return digit_scatter_walk_kernel<W, kFirst, kBits>;
  } else {
    return digit_scatter_kernel<W, kFirst, kBits>;
  }
}

// Sorts (keys, W words) from the a-buffers, stably, by the low kBits *
// passes bits; the live entries are the first *live_in (m where null), and
// the first pass drops kSkip keys. On return the a-pointers hold the
// result. With iota (W 1) the first pass takes each entry's index as its
// word, and vals_a is not read. Without kWalk the grid is sized to the tiles, one a block (the
// entries routes: m entries, kSkip keys dropped by the first pass); with it
// (the runs route's packed descriptors, whose count lives on the card) it
// is capped at grid_cap blocks, which walk the live tiles.
template <int W, int kBits, bool kWalk>
void radix_sort(SortBuffers& s, uint32_t m, const uint32_t* live_in, uint32_t passes,
                int grid_cap, cudaStream_t stream, bool iota = false) {
  constexpr int kItems = sort_items(W);
  const uint32_t tiles = s.stride > 0 ? s.stride : 1;
  const unsigned grid = !kWalk || tiles < static_cast<uint32_t>(grid_cap)
                            ? tiles : static_cast<unsigned>(grid_cap);
  for (uint32_t p = 0; p < passes; ++p) {
    const int shift = static_cast<int>(p) * kBits;
    const uint32_t* live = p == 0 ? live_in : s.count;
    digit_count_kernel<kItems, kBits><<<grid, kThreads, 0, stream>>>(s.keys_a, live, m, shift,
                                                                     s.counts, s.stride);
    digit_scan_kernel<<<1 << kBits, kThreads, 0, stream>>>(s.counts, s.stride, live, m,
                                                           kThreads * kItems, s.totals);
    auto scatter = p == 0 ? scatter_of<W, kBits, kWalk, true>()
                          : scatter_of<W, kBits, kWalk, false>();
    scatter<<<grid, kThreads, 0, stream>>>(s.keys_a, iota && p == 0 ? nullptr : s.vals_a,
                                           s.keys_b, s.vals_b, live, m, s.count, shift,
                                           s.counts, s.stride, s.totals);
    uint32_t* k = s.keys_a;
    s.keys_a = s.keys_b;
    s.keys_b = k;
    float* v = s.vals_a;
    s.vals_a = s.vals_b;
    s.vals_b = v;
  }
}

// Rows of level l of the table.
uint64_t rows_of(int l, const int* res, const int* dense, uint32_t hash_mask) {
  const uint64_t r = static_cast<uint64_t>(res[l]);
  return dense[l] ? r * r * r : hash_mask + 1ull;
}

// Rows of the table up to the end of the list's last level.
uint32_t rows_through(const LevelList& list, const int* res, const int* offsets,
                      const int* dense, uint32_t hash_mask) {
  const int l = list.level[list.count - 1];
  return static_cast<uint32_t>(offsets[l] + rows_of(l, res, dense, hash_mask));
}

// Rows of the list's largest level: the runs' sort orders them by the low
// bits that tell a level's rows apart, since two rows of one level differ by
// less than its size, and the descriptors come level by level, so equal low
// bits of two levels' rows stay apart in that (stable) order.
uint64_t largest_level(const LevelList& list, const int* res, const int* dense,
                       uint32_t hash_mask) {
  uint64_t most = 1;
  for (int i = 0; i < list.count; ++i)
    most = std::max<uint64_t>(most, rows_of(list.level[i], res, dense, hash_mask));
  return most;
}

template <int F, bool kTetra, bool kStochastic, class LS>
void launch_runs(const float* pos, const float* g, float* grad, uint32_t n, int L, const LS& lv,
                 const LevelList& list, uint64_t level_rows, RunBuffers b, int grid_cap, Feat ft,
                 cudaStream_t stream) {
  constexpr int VE = kStochastic ? 1 : (kTetra ? 4 : 8);
  const RouteShape rs = run_shape(n, list.count, F, VE);
  const uint32_t chunks = rs.chunks * list.count;
  run_emit_kernel<F, kTetra, kStochastic, LS>
      <<<dim3(rs.chunks, list.count), kThreads, 0, stream>>>(
          pos, g, n, L, lv, list, rs.chunks, ft, b.vals, b.sort.keys_b,
          reinterpret_cast<uint2*>(b.sort.vals_b), b.run_count);
  digit_scan_kernel<<<1, kThreads, 0, stream>>>(b.run_count, 0, nullptr, chunks, 1, b.run_total);
  compact_runs_kernel<<<(chunks + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      b.sort.keys_b, reinterpret_cast<const uint2*>(b.sort.vals_b), b.run_count, b.run_total,
      chunks, chunk_entries(F), b.sort.keys_a, reinterpret_cast<uint2*>(b.sort.vals_a));
  radix_sort<2, kRunDigitBits, true>(b.sort, static_cast<uint32_t>(rs.slots), b.run_total,
                                     sort_passes(level_rows, kRunDigitBits), grid_cap, stream);
  const uint64_t warps = ceil_div(rs.slots, 32);
  const uint64_t blocks = ceil_div(warps, kWarps);
  run_fold_kernel<F><<<blocks < static_cast<uint64_t>(grid_cap) ? blocks : grid_cap, kThreads, 0,
                       stream>>>(b.sort.keys_a, reinterpret_cast<const uint2*>(b.sort.vals_a),
                                 b.sort.count, b.vals, grad, ft);
}

template <int F, bool kTetra, bool kStochastic>
void launch_entries(const float* pos, const float* g, float* grad, uint32_t n, int L,
                    const Levels& lv, const LevelList& list, uint32_t rows, SortBuffers s,
                    int grid_cap, Feat ft, cudaStream_t stream) {
  constexpr int VE = kStochastic ? 1 : (kTetra ? 4 : 8);
  const uint32_t m = n * list.count * VE;
  emit_kernel<F, kTetra, kStochastic><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pos, g, s.keys_a, s.vals_a, n, L, lv, list);
  radix_sort<F, kDigitBits, false>(s, m, nullptr, sort_passes(rows, kDigitBits), grid_cap,
                                   stream);
  const uint64_t warps = ceil_div(m, kSumBatch);
  const unsigned blocks = static_cast<unsigned>(ceil_div(warps, kWarps));
  row_sum_kernel<F><<<blocks, kThreads, 0, stream>>>(s.keys_a, s.vals_a, s.count, grad, ft);
}

// The two routes' level lists from the per-level flags (nonzero: runs).
void split_levels(int L, const int* runs, LevelList& by_runs, LevelList& by_entries) {
  by_runs.count = by_entries.count = 0;
  for (int l = 0; l < L; ++l) {
    LevelList& list = runs != nullptr && runs[l] ? by_runs : by_entries;
    list.level[list.count++] = l;
  }
}

// Scratch bytes of both routes (they run one after the other and share it).
size_t route_scratch(void* base, uint64_t n, int F, int VE, const LevelList& by_runs,
                     const LevelList& by_entries, RunBuffers* rb, SortBuffers* sb) {
  Carver runs{static_cast<char*>(base)}, entries{static_cast<char*>(base)};
  RunBuffers r{};
  SortBuffers s{};
  if (by_runs.count) r = run_buffers(runs, n, by_runs.count, F, VE);
  if (by_entries.count) s = sort_buffers(entries, n * by_entries.count * VE, F, kDigitBits);
  if (rb) *rb = r;
  if (sb) *sb = s;
  return runs.off > entries.off ? runs.off : entries.off;
}

template <int F, bool kTetra, bool kStochastic>
cudaError_t launch(const float* pos, const float* g, float* grad, uint32_t n, int L,
                   const Levels& lv, const int* res, const int* offsets, const int* dense,
                   const LevelList& by_runs, const LevelList& by_entries, const RunBuffers& rb,
                   const SortBuffers& sb, Feat ft, cudaStream_t stream) {
  const int grid_cap = umhs::num_sms() * kBlocksPerSm;
  if (by_runs.count)
    launch_runs<F, kTetra, kStochastic, Levels>(
        pos, g, grad, n, L, lv, by_runs, largest_level(by_runs, res, dense, lv.hash_mask), rb,
        grid_cap, ft, stream);
  if (by_entries.count)
    launch_entries<F, kTetra, kStochastic>(
        pos, g, grad, n, L, lv, by_entries,
        rows_through(by_entries, res, offsets, dense, lv.hash_mask), sb, grid_cap, ft, stream);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_f(bool tetra, bool stochastic, const float* pos, const float* g, float* grad,
                     uint32_t n, int L, const Levels& lv, const int* res, const int* offsets,
                     const int* dense, const LevelList& by_runs, const LevelList& by_entries,
                     const RunBuffers& rb, const SortBuffers& sb, Feat ft, cudaStream_t s) {
  if (tetra)
    return stochastic ? launch<F, true, true>(pos, g, grad, n, L, lv, res, offsets, dense,
                                               by_runs, by_entries, rb, sb, ft, s)
                      : launch<F, true, false>(pos, g, grad, n, L, lv, res, offsets, dense,
                                                by_runs, by_entries, rb, sb, ft, s);
  return stochastic ? launch<F, false, true>(pos, g, grad, n, L, lv, res, offsets, dense,
                                              by_runs, by_entries, rb, sb, ft, s)
                    : launch<F, false, false>(pos, g, grad, n, L, lv, res, offsets, dense,
                                               by_runs, by_entries, rb, sb, ft, s);
}

// ------------------------------------------------- the any route's launches

// Features a kernel of the any route takes at a time (its template F): a
// row of F features is cut into groups of kGroup and the rest.
constexpr int kGroup = 8;
constexpr int kAnyDigitBits = 9;  // its entries' sort: level-local digits
constexpr int kEmitStagedBytes = 200 * 1024;  // emit_any_kernel's staged values at most

// The any route's work at one (L, F, mode, route flags): the levels on the
// runs route in lists of at most kMaxLevels, and the entries' levels.
struct AnyShape {
  int L, F, VE;
  bool tetra, stoch;
  const int* runs;  // per level, nonzero for the runs route (or null)
  int run_lists;
  LevelList run_list[(1024 + umhs::kMaxLevels - 1) / umhs::kMaxLevels];
  int entry_levels;
};

bool any_shape(AnyShape& a, int L, int F, bool tetra, bool stoch, const int* runs) {
  if (L > 1024) return false;
  a.L = L;
  a.F = F;
  a.tetra = tetra;
  a.stoch = stoch;
  a.VE = stoch ? 1 : (tetra ? 4 : 8);
  a.runs = runs;
  a.run_lists = 0;
  a.entry_levels = 0;
  for (int l = 0; l < L; ++l) {
    if (runs == nullptr || !runs[l]) {
      ++a.entry_levels;
      continue;
    }
    if (a.run_lists == 0 || a.run_list[a.run_lists - 1].count == umhs::kMaxLevels)
      a.run_list[a.run_lists++].count = 0;
    LevelList& list = a.run_list[a.run_lists - 1];
    list.level[list.count++] = l;
  }
  return true;
}

// The any route's buffers: the entries' sort of (key, slot index) and their
// values; the runs route's buffers (one feature group at a time) share the
// scratch with them, since the two run one after the other.
struct AnyBuffers {
  SortBuffers sort;
  float* vals;
  RunBuffers runs;
};

size_t any_buffers(void* base, uint64_t n, const AnyShape& a, AnyBuffers* b) {
  Carver entries{static_cast<char*>(base)};
  AnyBuffers r{};
  const uint64_t m = n * a.entry_levels * a.VE;
  if (a.entry_levels) {
    r.sort = sort_buffers(entries, m, 1, kAnyDigitBits);
    r.vals = entries.take<float>(m * static_cast<uint64_t>(padded_width(a.F)));
  }
  size_t most = entries.off;
  if (a.run_lists) {
    // the largest list and the widest groups (kGroup, and the rest)
    const int fgs[2] = {std::min(a.F, kGroup), a.F % kGroup};
    for (const int fg : fgs) {
      if (fg == 0) continue;
      Carver runs{static_cast<char*>(base)};
      run_buffers(runs, n, a.run_list[0].count, fg, a.VE);
      if (runs.off > most) most = runs.off;
    }
  }
  if (b) *b = r;
  return most;
}

template <int F>
void row_sum_group(const SortBuffers& s, const float* vals, uint64_t m, float* grad, Feat ft,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(ceil_div(ceil_div(m, kAnyBatch), kAnyWarps));
  row_sum_any_kernel<F><<<blocks, 32 * kAnyWarps, 0, stream>>>(
      s.keys_a, s.vals_a, s.count, static_cast<uint32_t>(m), vals, grad, ft);
}

template <int F, bool kTetra, bool kStochastic>
void runs_group(const float* pos, const float* g, float* grad, uint32_t n, const AnyShape& a,
                const LevelTable& lt, const LevelList& list, uint64_t rows, void* scratch,
                int grid_cap, Feat ft, cudaStream_t stream) {
  Carver cv{static_cast<char*>(scratch)};
  const RunBuffers rb = run_buffers(cv, n, list.count, F, a.VE);
  launch_runs<F, kTetra, kStochastic, LevelTable>(pos, g, grad, n, a.L, lt, list, rows, rb,
                                                  grid_cap, ft, stream);
}

// A feature group of fg features (1..kGroup) to its template instance.
template <template <int> class Fn, typename... Args>
void by_group(int fg, Args&&... args) {
  switch (fg) {
    case 1: Fn<1>::run(args...); break;
    case 2: Fn<2>::run(args...); break;
    case 3: Fn<3>::run(args...); break;
    case 4: Fn<4>::run(args...); break;
    case 5: Fn<5>::run(args...); break;
    case 6: Fn<6>::run(args...); break;
    case 7: Fn<7>::run(args...); break;
    default: Fn<8>::run(args...); break;
  }
}

template <int F>
struct RowSumGroup {
  template <typename... Args>
  static void run(Args&&... args) { row_sum_group<F>(args...); }
};

template <bool kTetra, bool kStochastic>
struct RunsGroupOf {
  template <int F>
  struct Fn {
    template <typename... Args>
    static void run(Args&&... args) { runs_group<F, kTetra, kStochastic>(args...); }
  };
};

// The any route on samples [0, n) of pos and g (a range of the call's):
// the runs levels list by list and feature group by feature group, then
// the entries' levels: every entry emitted, sorted once by (key, slot
// index) on level-local 9-bit digits, and summed a feature group at a time.
template <bool kTetra, bool kStochastic>
cudaError_t launch_any(const float* pos, const float* g, float* grad, uint32_t n,
                       const AnyShape& a, const LevelTable& lt, const int* res, const int* dense,
                       void* scratch, int acc, cudaStream_t stream) {
  constexpr int VE = kStochastic ? 1 : (kTetra ? 4 : 8);
  const int grid_cap = umhs::num_sms() * kBlocksPerSm;
  for (int i = 0; i < a.run_lists; ++i) {
    const LevelList& list = a.run_list[i];
    const uint64_t rows = largest_level(list, res, dense, lt.hash_mask);
    for (int f0 = 0; f0 < a.F; f0 += kGroup)
      by_group<RunsGroupOf<kTetra, kStochastic>::template Fn>(
          std::min(kGroup, a.F - f0), pos, g, grad, n, a, lt, list, rows, scratch, grid_cap,
          Feat{a.F, f0, acc}, stream);
  }
  if (a.entry_levels == 0) return cudaGetLastError();
  AnyBuffers b;
  any_buffers(scratch, n, a, &b);
  uint64_t base = 0, largest = 1;
  for (int l0 = 0; l0 < a.L;) {
    if (a.runs != nullptr && a.runs[l0]) {
      ++l0;
      continue;
    }
    int l1 = l0;
    while (l1 < a.L && (a.runs == nullptr || !a.runs[l1])) {
      largest = std::max<uint64_t>(largest, rows_of(l1, res, dense, lt.hash_mask));
      ++l1;
    }
    auto emit = emit_any_kernel<kTetra, kStochastic>;
    const int smem =
        kEmitSamples * (VE * padded_width(a.F) + 1) * static_cast<int>(sizeof(float));
    const bool staged = smem <= kEmitStagedBytes;
    if (staged && smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(emit, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    emit<<<dim3(static_cast<unsigned>(ceil_div(n, kEmitSamples)), static_cast<unsigned>(l1 - l0)),
           kEmitSamples, staged ? smem : 0, stream>>>(pos, g, b.sort.keys_a, b.vals, n, a.L, a.F,
                                                      lt, l0, static_cast<uint32_t>(base),
                                                      staged);
    base += static_cast<uint64_t>(l1 - l0) * n * VE;
    l0 = l1;
  }
  radix_sort<1, kAnyDigitBits, false>(b.sort, static_cast<uint32_t>(base), nullptr,
                                      sort_passes(largest, kAnyDigitBits), grid_cap, stream,
                                      true);
  for (int f0 = 0; f0 < a.F; f0 += kGroup)
    by_group<RowSumGroup>(std::min(kGroup, a.F - f0), b.sort, b.vals, base, grad,
                          Feat{a.F, f0, acc}, stream);
  return cudaGetLastError();
}

constexpr uint64_t kMaxEntries = 0x7fffffffull;  // slot indices fit int32
// A call's samples are cut into ranges whose entries fit int32 and whose
// scratch fits this; each range's sums go on from the ranges before.
constexpr uint64_t kScratchCap = uint64_t{8} << 30;

// One call's shape: what the scratch of a range of samples depends on.
struct CallShape {
  int L, F, VE;
  bool fixed;
  LevelList by_runs, by_entries;  // fixed
  AnyShape any;
};

bool call_shape(CallShape& c, int L, int F, bool tetra, bool stoch, const int* runs) {
  c.L = L;
  c.F = F;
  c.VE = stoch ? 1 : (tetra ? 4 : 8);
  c.fixed = umhs::fixed_shape(L, F);
  if (c.fixed) {
    split_levels(L, runs, c.by_runs, c.by_entries);
    return true;
  }
  return any_shape(c.any, L, F, tetra, stoch, runs);
}

size_t range_scratch(const CallShape& c, uint64_t ns) {
  if (c.fixed)
    return route_scratch(nullptr, ns, c.F, c.VE, c.by_runs, c.by_entries, nullptr, nullptr);
  return any_buffers(nullptr, ns, c.any, nullptr);
}

// Samples a range: the most whose entries fit int32 and whose scratch fits
// kScratchCap (at least one), at most max_range where that is positive.
uint64_t range_samples(const CallShape& c, uint64_t n, int64_t max_range) {
  uint64_t hi = std::min<uint64_t>(n, kMaxEntries / (static_cast<uint64_t>(c.L) * c.VE));
  if (max_range > 0) hi = std::min<uint64_t>(hi, static_cast<uint64_t>(max_range));
  hi = std::max<uint64_t>(hi, 1);
  if (range_scratch(c, hi) <= kScratchCap) return hi;
  uint64_t lo = 1;  // the scratch grows with the samples: the largest that fits
  while (lo < hi) {
    const uint64_t mid = lo + (hi - lo + 1) / 2;
    if (range_scratch(c, mid) <= kScratchCap) lo = mid; else hi = mid - 1;
  }
  return lo;
}

}  // namespace

// Bytes of scratch device memory umhs_hash_encode_bwd needs for n samples
// at L levels of F features, with runs[l] != 0 for the levels that take the
// runs route: those of its largest range of samples (0 for no sample).
extern "C" int64_t umhs_hash_encode_bwd_scratch_bytes(int64_t n, int L, int F, int tetrahedral,
                                                      int stochastic, const int* runs) {
  CallShape c;
  if (n <= 0 || L < 1 || F < 1 || !call_shape(c, L, F, tetrahedral != 0, stochastic != 0, runs))
    return 0;
  return static_cast<int64_t>(range_scratch(c, range_samples(c, static_cast<uint64_t>(n), 0)));
}

// pos: (n, 3) f32 in [0, 1]; g: (n, L * F) f32, the gradient of K3's
// output, aligned to 4 * F bytes on the fixed route; grad: (rows * F,) f32,
// likewise aligned, zeroed by the caller; every row with a contribution is
// written. scales/res/offsets/dense: per-level host arrays of length L;
// runs: per level, nonzero for the runs route (the wrapper's
// hash_encode_bwd_route); level_table: the any route's device table
// (`_level_table`). scratch: umhs_hash_encode_bwd_scratch_bytes(...) bytes
// of device memory, aligned to 256, given as scratch_bytes. The samples go
// in ranges (range_samples; max_range > 0 caps a range's samples, so that
// a check can force several), each range's sums going on from the ones
// before, so the bits are one range's. Returns a cudaError_t.
extern "C" int umhs_hash_encode_bwd(const float* pos, const float* g, float* grad,
                                    int64_t n, int L, int F, const float* scales,
                                    const int* res, const int* offsets, const int* dense,
                                    int log2_hashmap_size, int tetrahedral, int stochastic,
                                    const int* runs, const void* level_table, void* scratch,
                                    int64_t scratch_bytes, int64_t max_range, void* stream,
                                    int32_t* route) {
  if (n < 0 || L < 1 || F < 1 || log2_hashmap_size < 1 || log2_hashmap_size > 31)
    return cudaErrorInvalidValue;
  const bool tetra = tetrahedral != 0, stoch = stochastic != 0;
  CallShape c;
  if (!call_shape(c, L, F, tetra, stoch, runs)) return cudaErrorInvalidValue;
  const uintptr_t align = c.fixed ? 4 * F : 4;
  if (reinterpret_cast<uintptr_t>(g) % align != 0 ||
      reinterpret_cast<uintptr_t>(grad) % align != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 256 != 0)
    return cudaErrorMisalignedAddress;
  auto s = static_cast<cudaStream_t>(stream);
  Levels lv;
  if (c.fixed) {
    if (!umhs::fill_levels(lv, L, scales, res, offsets, dense, log2_hashmap_size))
      return cudaErrorInvalidValue;
  } else if (level_table == nullptr || reinterpret_cast<uintptr_t>(level_table) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  *route = c.fixed ? 0 : 1;
  if (n == 0) return cudaSuccess;
  const uint64_t per = range_samples(c, static_cast<uint64_t>(n), max_range);
  if (scratch == nullptr || scratch_bytes < static_cast<int64_t>(range_scratch(c, per)))
    return cudaErrorInvalidValue;
  const uint32_t mask = (1u << log2_hashmap_size) - 1u;
  const LevelTable lt{static_cast<const umhs::LevelArg*>(level_table), mask};
  for (uint64_t s0 = 0; s0 < static_cast<uint64_t>(n); s0 += per) {
    const uint32_t ns = static_cast<uint32_t>(std::min<uint64_t>(per, n - s0));
    const float* p = pos + 3 * s0;
    const float* gs = g + s0 * static_cast<uint64_t>(L) * F;
    const int acc = s0 > 0;
    cudaError_t err;
    if (!c.fixed) {
      err = tetra ? (stoch ? launch_any<true, true>(p, gs, grad, ns, c.any, lt, res, dense,
                                                     scratch, acc, s)
                           : launch_any<true, false>(p, gs, grad, ns, c.any, lt, res, dense,
                                                      scratch, acc, s))
                  : (stoch ? launch_any<false, true>(p, gs, grad, ns, c.any, lt, res, dense,
                                                      scratch, acc, s)
                           : launch_any<false, false>(p, gs, grad, ns, c.any, lt, res, dense,
                                                       scratch, acc, s));
    } else {
      RunBuffers rb;
      SortBuffers sb;
      route_scratch(scratch, ns, F, c.VE, c.by_runs, c.by_entries, &rb, &sb);
      const Feat ft{F, 0, acc};
      switch (F) {
        case 1: err = launch_f<1>(tetra, stoch, p, gs, grad, ns, L, lv, res, offsets, dense,
                                  c.by_runs, c.by_entries, rb, sb, ft, s); break;
        case 2: err = launch_f<2>(tetra, stoch, p, gs, grad, ns, L, lv, res, offsets, dense,
                                  c.by_runs, c.by_entries, rb, sb, ft, s); break;
        case 4: err = launch_f<4>(tetra, stoch, p, gs, grad, ns, L, lv, res, offsets, dense,
                                  c.by_runs, c.by_entries, rb, sb, ft, s); break;
        default: err = launch_f<8>(tetra, stoch, p, gs, grad, ns, L, lv, res, offsets, dense,
                                   c.by_runs, c.by_entries, rb, sb, ft, s); break;
      }
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
