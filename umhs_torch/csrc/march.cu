// K5: the occupancy grid's march, in two launches.
//
// Replaces the XLA code of umhs_tpu/ops/ray_marching.py:250 `march_rays`
// (with `candidate_ts` :112, `_ts_at_index` :142, `_rank_select` :168) and
// the packed-word queries of umhs_tpu/ops/occupancy.py:255-315. In the
// original system nerfacc's CUDA ray-marching kernel did this work. The port
// ran it as plain PyTorch (umhs_torch/ops/ray_marching.py, march_rays_plain):
// some 220 operator calls a march, and two gathers of the packed words that
// took a third of the steady training step's device time.
//
// Per ray, with the flagship's settings in brackets (1024 candidates, 4
// fine samples a cell, pool 4, 64 samples a ray):
// 1. Clip to the AABB of the outermost level: t0 = max(t_enter, near) plus
//    jitter * render_step_size when training; t_max = min(t_exit, far).
// 2. Pre-pass (pool > 1): Ma [64] supercell candidates on the cone schedule
//    at step dt0 * k * p; a candidate is kept if its supercell is occupied,
//    it lies inside the grid and t < t_max. Rank-select up to `supers` [32]
//    of them: a ray over budget takes an even stride, its dt scaled by
//    count / budget, (t, dt) recomputed from the schedule at the index.
// 3. Split each kept supercell interval into p [4] cell intervals and query
//    each cell's bit; without a pre-pass, query Mc [256] candidates on the
//    schedule at step dt0 * k. Optional od culling drops the candidates
//    behind an optical depth (sum of occs_low * dt / dt0) above od_max.
// 4. Rank-select Sc [16] of the M [128] candidates under the batch budget
//    total_budget // k, which needs the sum over all rays of min(count, Sc):
//    hence two launches. Emit k [4] fine intervals a kept candidate.
//
// K5a (march_count_kernel): a warp a ray. Each lane takes every 32nd
// candidate; a ballot gives a 32-bit word of occupancy bits per 32
// candidates, and word w stays in lane w where a stage has at most 32
// words (1,024 candidates). Past that (the WIDE kernels) each word goes to
// the state row as its ballot is taken, and the searches below run over the
// row: lane l sums the popcounts of words [l n, (l + 1) n), n = ceil(words /
// 32), a warp scan over the lanes' sums finds a rank's lane, the lane walks
// its words, and a popcount search finds the bit. It walks only the words
// that can hold an occupied candidate:
// the pre-pass's words and, without a pre-pass, the cells' up to the first
// word whose last candidate starts at or past t_max (the schedule's t never
// decreases with the index); after a pre-pass, the cells' words up to
// ceil(budget * pool / 32), budget = min(the pre-pass's count, supers),
// none when it kept nothing. Each kept supercell's interval is computed
// once, by one lane, and handed to its pool cell candidates by shuffle. It
// writes the ray's state (t0, count, the pre-pass's count, the fine and
// pre-pass words; the words it did not walk are 0), num_occupied, and adds
// the block's sum of min(count, Sc) to a device int32 total (one integer
// atomicAdd a block: exact and order-free).
//
// K5b (march_emit_kernel): a ray a segment of 32 lanes, or of 16 (two rays
// a warp) where its slots and words fit: the kernel is bound by its
// instruction rate, and the flagship's 16 slots a ray fill half a warp. A
// lane a slot, in rounds. The batch scale from the device total, then per
// slot its rank, its candidate found by a shuffle binary search over the words'
// running counts and a popcount search in the word (past 32 words a stage,
// the two-level search over the row), the candidate's (t, dt)
// recomputed once (after a pre-pass, its supercell's from the pre-pass's
// words by the same search), and the slot's k fine intervals written
// straight into the (R, S) outputs: at k 4 by the slot's lane in one
// 16-byte store each for t_starts and t_ends and a 4-byte one for the mask,
// at another k shuffled to the columns' lanes. No float atomics, no host
// sync; every output is written by one thread, so every run gives the same
// bits. K5a could hand K5b each kept supercell's candidate index in the
// state row instead of that search: timed in turns, the stores cost K5a 6
// registers and 9% (0.0898 -> 0.0977 ms at phase 7's steady batch) and
// saved K5b 0.0012 ms, so K5b searches.
//
// The arithmetic follows PyTorch's CUDA kernels op by op (occupancy.cuh),
// so the outputs equal the plain version's on the card bit for bit. The od
// culling is the exception: it sums a ray's candidates one at a time in
// f32, where the plain version's cumsum takes another order.
//
// What bounds it on an H100: neither bytes nor operations at these sizes.
// The outputs are (2 * 4 + 1) * S bytes a ray (~48.6 MB at phase 7's 79,360
// rays and S 64, ~0.015 ms); the word table (2 MB) stays in the L2. Each
// candidate costs an exp, a log2, three IEEE divisions and a dependent L2
// load, so the work is latency and issue: K5a's design cuts the candidates
// and the instructions a candidate, not the bytes.
#include <stdint.h>

#include "common.cuh"
#include "occupancy.cuh"

namespace umhs {

// One candidate schedule (nerfacc's cone marching): dt = max(t * cone, dt0),
// linear until t reaches dt0 / cone, geometric after. Mirrors
// umhs_torch/ops/ray_marching.py's Schedule.
struct Schedule {
  float dt0, cone;
  float inv_dt0;  // float32(1) / float32(dt0)
  float t_crit;   // float32(dt0 / cone), divided in double
  float growth;   // log1p(cone) as PyTorch computes it on the card
  int32_t linear; // cone <= 0
};

// Mirrors umhs_torch/ops/ray_marching.py's MarchParams field for field.
struct MarchParams {
  OccParams grid;
  int32_t R;
  int32_t M;       // fine candidates a ray (supers * pool, or Mc)
  int32_t Ma;      // pre-pass candidates a ray (0 without a pre-pass)
  int32_t Sc;      // slots a ray (num_samples // k)
  int32_t supers;  // pre-pass slots
  int32_t k;       // fine samples a slot
  int32_t pool;    // cells a supercell along an axis (1 without a pre-pass)
  int32_t pre_mode, fine_mode, od, has_budget, total_budget;
  int32_t words_fine, words_pre, width;
  float lo[3], hi[3], tiny, near_plane, far_plane, jitter_step;
  float inv_p, inv_k, od_inv_step, od_max;
  Schedule pre, coarse;
};

}  // namespace umhs

namespace {

using umhs::MarchParams;
using umhs::Schedule;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block (K5b)
constexpr int kCountWarps = 4;  // rays per block (K5a; of 2, 4 and 8 by a timed sweep)
enum Query { kNone = 0, kPacked = 1, kBytes = 2 };

// Schedule state of one ray: the linear steps before the geometric phase.
struct RaySchedule {
  float t0, k_crit, t_at_crit;
};

__device__ __forceinline__ RaySchedule ray_schedule(const Schedule& s, float t0) {
  RaySchedule r{t0, 0.0f, t0};
  if (!s.linear) {
    // ceil(clamp_min(t_crit - t0, 0) / dt0): the division by a Python number
    r.k_crit = ceilf(__fmul_rn(umhs::clamp_min_f(__fsub_rn(s.t_crit, t0), 0.0f), s.inv_dt0));
    r.t_at_crit = __fadd_rn(t0, __fmul_rn(r.k_crit, s.dt0));
  }
  return r;
}

// (t, dt) of candidate index kf.
__device__ __forceinline__ void schedule_at(const Schedule& s, const RaySchedule& r, float kf,
                                            float& t, float& dt) {
  const float t_lin = __fadd_rn(r.t0, __fmul_rn(kf, s.dt0));
  if (s.linear) {
    t = t_lin;
    dt = s.dt0;
    return;
  }
  const float t_exp = __fmul_rn(r.t_at_crit, expf(__fmul_rn(__fsub_rn(kf, r.k_crit), s.growth)));
  t = kf < r.k_crit ? t_lin : t_exp;
  dt = umhs::clamp_min_f(__fmul_rn(t, s.cone), s.dt0);
}

__device__ __forceinline__ int warp_sum(int v) { return __reduce_add_sync(kFull, v); }

// Exclusive scan over a segment of W lanes (`lane` within it).
template <int W = 32>
__device__ __forceinline__ int warp_exclusive_scan(int v, int lane) {
  int x = v;
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o, W);
    if (lane >= o) x += y;
  }
  return x - v;
}

// Position of the n-th (0-based) set bit of w (n < popc(w)).
__device__ __forceinline__ int nth_set_bit(unsigned w, int n) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int c = __popc(w & ((1u << width) - 1u));
    if (n >= c) {
      n -= c;
      w >>= width;
      pos += width;
    }
  }
  return pos;
}

// A stage's occupancy words, word w in lane w of a segment of W lanes, with
// their exclusive running counts: the candidate index of the occupied
// candidate of rank `rank` (0-based), or M - 1 past the count
// (searchsorted's M, clamped). Called by every lane of the warp, each with
// its own rank.
template <int W = 32>
__device__ __forceinline__ int select_index(unsigned word, int excl, int nwords, int rank,
                                            int M) {
  int lo = 0;  // the last word whose running count is <= rank
#pragma unroll
  for (int step = W / 2; step >= 1; step >>= 1) {
    const int cand = lo + step;
    const int v = __shfl_sync(kFull, excl, cand & (W - 1), W);
    if (cand < nwords && v <= rank) lo = cand;
  }
  const unsigned w = __shfl_sync(kFull, word, lo, W);
  const int n = rank - __shfl_sync(kFull, excl, lo, W);
  if (n < 0 || n >= __popc(w)) return M - 1;
  return 32 * lo + nth_set_bit(w, n);
}

// The exclusive scan over the warp's lanes of each lane's popcount of a
// stage's words in a state row, lane l holding words [l n, (l + 1) n) of
// the `nwords` (n = per_lane): the first level of select_index_wide.
__device__ __forceinline__ int lane_words_scan(const int32_t* __restrict__ words, int per_lane,
                                               int nwords, int lane) {
  int sum = 0;
  const int end = min((lane + 1) * per_lane, nwords);
  for (int c = lane * per_lane; c < end; ++c) sum += __popc(static_cast<unsigned>(words[c]));
  return warp_exclusive_scan(sum, lane);
}

// select_index over more than 32 words, from the state row: the last lane
// whose running count (lane_words_scan's `excl`) is <= rank by a shuffle
// binary search, then that lane's words walked for the word that holds the
// rank, then a popcount search in it; M - 1 past the count. Called by every
// lane of the warp, each with its own rank.
__device__ __forceinline__ int select_index_wide(const int32_t* __restrict__ words, int per_lane,
                                                 int nwords, int excl, int rank, int M) {
  const int lanes = (nwords + per_lane - 1) / per_lane;  // the lanes holding a word
  int lo = 0;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    const int cand = lo + step;
    const int v = __shfl_sync(kFull, excl, cand & 31);
    if (cand < lanes && v <= rank) lo = cand;
  }
  int n = rank - __shfl_sync(kFull, excl, lo);
  const int end = min((lo + 1) * per_lane, nwords);
  for (int c = lo * per_lane; c < end; ++c) {
    const unsigned w = static_cast<unsigned>(words[c]);
    const int p = __popc(w);
    if (n < p) return 32 * c + nth_set_bit(w, n);
    n -= p;
  }
  return M - 1;
}

// Slot `slot`'s occupied rank: an even stride when the ray is over budget.
__device__ __forceinline__ int slot_rank(int slot, int count, int budget) {
  return count > budget ? (slot * count) / max(budget, 1) : slot;
}

// dt's scale of a ray over budget: clamp_min(count / max(budget, 1), 1).
__device__ __forceinline__ float dt_scale_of(int count, int budget) {
  return umhs::clamp_min_f(
      __fdiv_rn(static_cast<float>(count), static_cast<float>(max(budget, 1))), 1.0f);
}

// The pre-pass's words and counts in a warp, and the ray's schedule; past
// 32 words, the words in the state row (`words`, per_lane a lane).
struct PrePass {
  unsigned word;
  int excl, count, budget;
  float dt_scale;
  RaySchedule rs;
  const int32_t* words;
  int per_lane;
};

// Kept supercell interval of pre-pass candidate `idx` in slot s: (0, 0) past
// the budget, else its (t, dt) with dt scaled as the ray's over budget.
__device__ __forceinline__ void supercell_interval(const Schedule& pre, const RaySchedule& rs,
                                                   int idx, bool valid, float dt_scale,
                                                   float& t, float& dt) {
  float ts, dts;
  schedule_at(pre, rs, static_cast<float>(idx), ts, dts);
  t = valid ? ts : 0.0f;
  dt = valid ? __fmul_rn(dts, dt_scale) : 0.0f;
}

// Pre-pass slot s's kept supercell interval. Called by every lane.
template <bool WIDE>
__device__ __forceinline__ void pre_slot(const MarchParams& P, const PrePass& A, int s,
                                         float& t, float& dt) {
  const int rank = slot_rank(s, A.count, A.budget);
  const int idx = WIDE ? select_index_wide(A.words, A.per_lane, P.words_pre, A.excl, rank, P.Ma)
                       : select_index(A.word, A.excl, P.words_pre, rank, P.Ma);
  supercell_interval(P.pre, A.rs, idx, s < A.budget, A.dt_scale, t, dt);
}

__device__ __forceinline__ void midpoint(const float o[3], const float d[3], float t, float dt,
                                         float pos[3]) {
  const float mid = __fadd_rn(t, __fmul_rn(dt, 0.5f));
#pragma unroll
  for (int c = 0; c < 3; ++c) pos[c] = __fadd_rn(o[c], __fmul_rn(d[c], mid));
}

// Supercell occupancy (pre-pass) of a world position: any bit of its packed
// word, or its byte in the pooled bitfield; and inside the grid.
__device__ __forceinline__ bool query_pre(const MarchParams& P, const float pos[3],
                                          const int64_t* __restrict__ packed,
                                          const uint8_t* __restrict__ pooled) {
  const umhs::OccParams& g = P.grid;
  if (P.pre_mode == kPacked) {
    const umhs::CellIndex c = umhs::locate_cell(g, pos, g.res);
    const int r4 = g.res >> 2;
    const int64_t row = static_cast<int64_t>(c.lvl) * r4 * r4 * r4 + (c.ijk[0] >> 2) +
                        static_cast<int64_t>(c.ijk[1] >> 2) * r4 +
                        static_cast<int64_t>(c.ijk[2] >> 2) * r4 * r4;
    return c.inside && (packed[2 * row] | packed[2 * row + 1]) != 0;
  }
  const int rp = g.res / P.pool;
  const umhs::CellIndex c = umhs::locate_cell(g, pos, rp);
  const int64_t flat = static_cast<int64_t>(c.lvl) * rp * rp * rp + c.ijk[0] +
                       static_cast<int64_t>(c.ijk[1]) * rp +
                       static_cast<int64_t>(c.ijk[2]) * rp * rp;
  return c.inside && pooled[flat] != 0;
}

// Cell occupancy of a world position: its bit in the packed words, or its
// byte in the bitfield; and inside the grid. `cell_flat` gets the cell's
// flat index (for the od culling's occs_low).
__device__ __forceinline__ bool query_fine(const MarchParams& P, const float pos[3],
                                           const int64_t* __restrict__ packed,
                                           const uint8_t* __restrict__ binaries,
                                           int64_t& cell_flat) {
  const umhs::OccParams& g = P.grid;
  const int res = g.res;
  const umhs::CellIndex c = umhs::locate_cell(g, pos, res);
  cell_flat = static_cast<int64_t>(c.lvl) * res * res * res + c.ijk[0] +
              static_cast<int64_t>(c.ijk[1]) * res + static_cast<int64_t>(c.ijk[2]) * res * res;
  if (P.fine_mode == kPacked) {
    const int r4 = res >> 2;
    const int64_t row = static_cast<int64_t>(c.lvl) * r4 * r4 * r4 + (c.ijk[0] >> 2) +
                        static_cast<int64_t>(c.ijk[1] >> 2) * r4 +
                        static_cast<int64_t>(c.ijk[2] >> 2) * r4 * r4;
    const int bit = (c.ijk[0] & 3) + ((c.ijk[1] & 3) << 2) + ((c.ijk[2] & 3) << 4);
    const int64_t word = packed[2 * row + (bit >> 5)];
    return c.inside && ((word >> (bit & 31)) & 1) == 1;
  }
  return c.inside && binaries[cell_flat] != 0;
}

// The pre-pass's words of a ray, from the state K5a wrote (or computes):
// in lanes (word), or past 32 words in the state row (`words`).
template <bool WIDE>
__device__ __forceinline__ PrePass pre_pass_of(const MarchParams& P, unsigned word, int count,
                                               float t0, int lane, const int32_t* words) {
  PrePass A;
  A.word = word;
  A.words = words;
  A.per_lane = (P.words_pre + 31) >> 5;
  A.excl = WIDE ? lane_words_scan(words, A.per_lane, P.words_pre, lane)
                : warp_exclusive_scan(__popc(word), lane);
  A.count = count;
  A.budget = min(count, P.supers);
  A.dt_scale = dt_scale_of(count, A.budget);
  A.rs = ray_schedule(P.pre, t0);
  return A;
}

// A word's ballot b, word c of a stage: kept in lane c, or past 32 words
// stored to the state row `words` by lane c % 32, which adds its bits to
// its `count` (the warp's sum of the lanes' counts is the stage's).
template <bool WIDE>
__device__ __forceinline__ void keep_word(unsigned b, int c, int lane, unsigned& word,
                                          int32_t* words, int& count) {
  if (WIDE) {
    if (lane == (c & 31)) {
      words[c] = static_cast<int32_t>(b);
      count += __popc(b);
    }
  } else if (lane == c) {
    word = b;
  }
}

// Past 32 words: words [from, nwords) of a state row that the walk did not
// reach, set to 0, and the row made visible to the warp's lanes.
__device__ __forceinline__ void clear_words_past(int32_t* words, int from, int nwords,
                                                 int lane) {
  for (int c = from + lane; c < nwords; c += 32) words[c] = 0;
  __syncwarp();
}

// One word of cell candidates, candidate 32 * c + lane in this lane: its
// occupancy bit, the od culling's when on; returns the word's ballot.
__device__ __forceinline__ unsigned fine_word(const MarchParams& P, const float o[3],
                                              const float d[3], float ts, float dts,
                                              bool in_range, const int64_t* __restrict__ packed,
                                              const uint8_t* __restrict__ binaries,
                                              const float* __restrict__ occs_low, int lane,
                                              float& od_run) {
  bool occ = false;
  int64_t cell = 0;
  if (in_range) {
    float pos[3];
    midpoint(o, d, ts, dts, pos);
    occ = query_fine(P, pos, packed, binaries, cell);
  }
  if (P.od) {
    // od before this candidate: the occupied candidates' occs_low * dt
    // / dt0 summed one at a time in candidate order
    const float contrib =
        __fmul_rn(occ ? occs_low[cell] : 0.0f, __fmul_rn(dts, P.od_inv_step));
    float od_here = 0.0f;
    for (int l = 0; l < 32; ++l) {
      const float cl = __shfl_sync(kFull, contrib, l);
      if (lane == l) od_here = od_run;
      od_run = __fadd_rn(od_run, cl);
    }
    occ = occ && od_here < P.od_max;
  }
  return __ballot_sync(kFull, occ);
}

// True when the word's last candidate (lane 31's) starts at or past t_max.
// A schedule's t never decreases with the index, so every later word's
// candidates are out of range too: a loop may stop there, uniformly.
__device__ __forceinline__ bool past_t_max(float t, float t_max) {
  return (__ballot_sync(kFull, t >= t_max) >> 31) != 0;
}

// WIDE: more than 32 fine or pre-pass words (the words to the state row as
// they are taken); else every word in a lane.
template <bool WIDE>
__global__ void __launch_bounds__(kCountWarps * 32)
march_count_kernel(const MarchParams P, const float* __restrict__ origins,
                   const float* __restrict__ dirs, const float* __restrict__ jitter,
                   const int64_t* __restrict__ packed, const uint8_t* __restrict__ binaries,
                   const uint8_t* __restrict__ pooled, const float* __restrict__ occs_low,
                   int32_t* __restrict__ state, int32_t* __restrict__ total,
                   int32_t* __restrict__ num_occupied) {
  __shared__ int32_t block_keep[kCountWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t r = blockIdx.x * kCountWarps + warp;
  int32_t keep = 0;
  if (r < P.R) {  // uniform over the warp
    float o[3], d[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = origins[3 * static_cast<int64_t>(r) + c];
      d[c] = dirs[3 * static_cast<int64_t>(r) + c];
    }
    // 1. the slab test: 1 / safe as reciprocal() rounds it
    float t_enter = -INFINITY, t_exit = INFINITY;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float safe = fabsf(d[c]) > P.tiny ? d[c] : P.tiny;
      const float inv = __fdiv_rn(1.0f, safe);
      const float ta = __fmul_rn(__fsub_rn(P.lo[c], o[c]), inv);
      const float tb = __fmul_rn(__fsub_rn(P.hi[c], o[c]), inv);
      t_enter = fmaxf(t_enter, fminf(ta, tb));
      t_exit = fminf(t_exit, fmaxf(ta, tb));
    }
    const float t_min = umhs::clamp_min_f(t_enter, P.near_plane);
    const float t_max = umhs::clamp_max_f(t_exit, P.far_plane);
    const float t0 =
        jitter != nullptr ? __fadd_rn(t_min, __fmul_rn(jitter[r], P.jitter_step)) : t_min;

    // WIDE: the state row, which takes each word as it is taken
    int32_t* const wide_row = WIDE ? state + static_cast<int64_t>(r) * P.width : nullptr;
    int32_t* const row_fine = wide_row + 3;
    int32_t* const row_pre = wide_row + 3 + P.words_fine;
    unsigned word = 0, word_pre = 0;
    int count_pre = 0, count_wide = 0;  // WIDE: this lane's words' bits, counted as taken
    float od_run = 0.0f;
    if (P.pre_mode != kNone) {
      // 2. the pre-pass's supercell words, up to the first word past t_max
      const RaySchedule rs = ray_schedule(P.pre, t0);
      int c = 0;
      for (; c < P.words_pre; ++c) {
        const int j = 32 * c + lane;
        float t, dt;
        schedule_at(P.pre, rs, static_cast<float>(j), t, dt);
        bool occ = false;
        if (j < P.Ma && t < t_max) {
          float pos[3];
          midpoint(o, d, t, dt, pos);
          occ = query_pre(P, pos, packed, pooled);
        }
        keep_word<WIDE>(__ballot_sync(kFull, occ), c, lane, word_pre, row_pre, count_pre);
        if (past_t_max(t, t_max)) break;
      }
      if (WIDE) clear_words_past(row_pre, c + 1, P.words_pre, lane);
      count_pre = warp_sum(WIDE ? count_pre : __popc(word_pre));
      const PrePass A = pre_pass_of<WIDE>(P, word_pre, count_pre, t0, lane, row_pre);

      // 3. the cells of the kept supercells. Slot s's interval is computed
      // once, by lane s % 32 in round s / 32, and handed to its pool cell
      // candidates by shuffle; a round's slots hold words [pool * h, pool *
      // (h + 1)). Candidates of slots at or past the budget are never
      // occupied, so the words past ceil(budget * pool / 32) stay 0.
      const int words = (A.budget * P.pool + 31) >> 5;
      for (int h = 0; 32 * h < A.budget; ++h) {  // uniform over the warp
        float tA, dtA;
        pre_slot<WIDE>(P, A, 32 * h + lane, tA, dtA);
        const int c_end = min(P.pool * (h + 1), words);
        for (int c = P.pool * h; c < c_end; ++c) {
          const int j = 32 * c + lane;
          const int s = j / P.pool, i = j - s * P.pool;
          const float ts_slot = __shfl_sync(kFull, tA, s - 32 * h);
          const float dts_slot = __shfl_sync(kFull, dtA, s - 32 * h);
          const float dts = __fmul_rn(dts_slot, P.inv_p);
          const float ts = __fadd_rn(ts_slot, __fmul_rn(static_cast<float>(i), dts));
          keep_word<WIDE>(fine_word(P, o, d, ts, dts, s < A.budget, packed, binaries, occs_low,
                                    lane, od_run),
                          c, lane, word, row_fine, count_wide);
        }
      }
      if (WIDE) clear_words_past(row_fine, words, P.words_fine, lane);
    } else {
      // 3. the cell candidates on the coarse schedule, up to the first word
      // past t_max
      const RaySchedule rc = ray_schedule(P.coarse, t0);
      int c = 0;
      for (; c < P.words_fine; ++c) {
        const int j = 32 * c + lane;
        float ts, dts;
        schedule_at(P.coarse, rc, static_cast<float>(j), ts, dts);
        keep_word<WIDE>(fine_word(P, o, d, ts, dts, j < P.M && ts < t_max, packed, binaries,
                                  occs_low, lane, od_run),
                        c, lane, word, row_fine, count_wide);
        if (past_t_max(ts, t_max)) break;
      }
      if (WIDE) clear_words_past(row_fine, c + 1, P.words_fine, lane);
    }
    const int count = warp_sum(WIDE ? count_wide : __popc(word));
    int32_t* row = state + static_cast<int64_t>(r) * P.width;
    if (lane == 0) {
      row[0] = __float_as_int(t0);
      row[1] = count;
      row[2] = count_pre;
      num_occupied[r] = count * P.k;
    }
    if (!WIDE) {
      if (lane < P.words_fine) row[3 + lane] = static_cast<int32_t>(word);
      if (lane < P.words_pre) row[3 + P.words_fine + lane] = static_cast<int32_t>(word_pre);
    }
    keep = min(count, P.Sc);
  }
  if (P.has_budget) {
    if (lane == 0) block_keep[warp] = keep;
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t sum = 0;
      for (int w = 0; w < kCountWarps; ++w) sum += block_keep[w];
      if (sum) atomicAdd(total, sum);
    }
  }
}

// The (t_start, t_end) of fine column q of a slot at (ts, dt_sel), as the
// plain version rounds them: t + q * (dt / k), then + dt / k; or t, t + dt.
__device__ __forceinline__ void fine_column(const MarchParams& P, float ts, float dt_sel, int q,
                                            float& t_start, float& t_end) {
  if (P.k > 1) {
    const float dt_fine = __fmul_rn(dt_sel, P.inv_k);
    t_start = __fadd_rn(ts, __fmul_rn(static_cast<float>(q), dt_fine));
    t_end = __fadd_rn(t_start, dt_fine);
  } else {
    t_start = ts;
    t_end = __fadd_rn(ts, dt_sel);
  }
}

// A ray a segment of W lanes (16: two rays a warp, where Sc <= 16 and the
// fine and pre-pass words <= 16 each; else 32), a lane a slot in rounds of
// W. K: 4, a slot's
// lane writes its four columns (16-byte stores); 0, any k, the slots'
// intervals shuffled to the columns' lanes (W columns a store). WIDE (W
// 32): more than 32 fine or pre-pass words, searched in the state row.
template <int K, int W, bool WIDE>
__global__ void __launch_bounds__(kWarps * 32)
march_emit_kernel(const MarchParams P, const int32_t* __restrict__ state,
                  const int32_t* __restrict__ total, float* __restrict__ t_starts,
                  float* __restrict__ t_ends, uint8_t* __restrict__ mask,
                  int32_t* __restrict__ num_samples) {
  const int lane = threadIdx.x & (W - 1);
  const int32_t r = (blockIdx.x * kWarps * 32 + threadIdx.x) / W;
  // a segment past the last ray runs ray R - 1's arithmetic with its warp's
  // shuffles and stores nothing
  const bool live = r < P.R;
  const int32_t* row = state + static_cast<int64_t>(live ? r : P.R - 1) * P.width;
  const float t0 = __int_as_float(row[0]);
  const int count = row[1];
  // WIDE: the words stay in the row, lane l's sum over words [l n, (l + 1) n)
  const int32_t* const row_fine = WIDE ? row + 3 : nullptr;
  const int32_t* const row_pre = WIDE ? row + 3 + P.words_fine : nullptr;
  const int per_fine = (P.words_fine + 31) >> 5, per_pre = (P.words_pre + 31) >> 5;
  const unsigned word =
      !WIDE && lane < P.words_fine ? static_cast<unsigned>(row[3 + lane]) : 0u;
  const int excl = WIDE ? lane_words_scan(row_fine, per_fine, P.words_fine, lane)
                        : warp_exclusive_scan<W>(__popc(word), lane);

  // the budget: min(count, Sc), scaled down with the batch's
  int budget = min(count, P.Sc);
  if (P.has_budget) {
    const float tot = static_cast<float>(max(*total, 1));
    const float scale =
        umhs::clamp_max_f(__fdiv_rn(static_cast<float>(P.total_budget), tot), 1.0f);
    budget = max(static_cast<int>(__fmul_rn(static_cast<float>(budget), scale)), min(count, 1));
  }
  const float dt_scale = dt_scale_of(count, budget);
  // the schedule of the slots' candidates: the pre-pass's supercells, or the
  // coarse one without a pre-pass
  const bool pre = P.pre_mode != kNone;
  const RaySchedule rs = ray_schedule(pre ? P.pre : P.coarse, t0);
  const int budget_pre = pre ? min(row[2], P.supers) : 0;
  const float dt_scale_pre = pre ? dt_scale_of(row[2], budget_pre) : 0.0f;
  const unsigned word_pre =
      !WIDE && pre && lane < P.words_pre ? static_cast<unsigned>(row[3 + P.words_fine + lane])
                                         : 0u;
  const int excl_pre = WIDE ? (pre ? lane_words_scan(row_pre, per_pre, P.words_pre, lane) : 0)
                            : warp_exclusive_scan<W>(__popc(word_pre), lane);

  const int S = P.Sc * P.k;
  const int64_t base = static_cast<int64_t>(r) * S;
  for (int s0 = 0; s0 < P.Sc; s0 += W) {  // uniform over the warp
    const int slot = s0 + lane;
    const bool valid = slot < budget;
    const int idx =
        WIDE ? select_index_wide(row_fine, per_fine, P.words_fine, excl,
                                 slot_rank(slot, count, budget), P.M)
             : select_index<W>(word, excl, P.words_fine, slot_rank(slot, count, budget), P.M);
    float ts, dts;
    if (pre) {  // the p-th part of its kept supercell's interval
      const int s = idx / P.pool, i = idx - s * P.pool;
      const int idxA =
          WIDE ? select_index_wide(row_pre, per_pre, P.words_pre, excl_pre,
                                   slot_rank(s, row[2], budget_pre), P.Ma)
               : select_index<W>(word_pre, excl_pre, P.words_pre,
                                 slot_rank(s, row[2], budget_pre), P.Ma);
      float tA, dtA;
      supercell_interval(P.pre, rs, idxA, s < budget_pre, dt_scale_pre, tA, dtA);
      dts = __fmul_rn(dtA, P.inv_p);
      ts = __fadd_rn(tA, __fmul_rn(static_cast<float>(i), dts));
    } else {
      schedule_at(P.coarse, rs, static_cast<float>(idx), ts, dts);
    }
    const float dt_sel = __fmul_rn(dts, dt_scale);
    if (K == 4) {
      if (live && slot < P.Sc) {
        float a[4], b[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fine_column(P, ts, dt_sel, q, a[q], b[q]);
          a[q] = valid ? a[q] : 0.0f;
          b[q] = valid ? b[q] : 0.0f;
        }
        const int64_t at = base + 4 * slot;
        *reinterpret_cast<float4*>(t_starts + at) = make_float4(a[0], a[1], a[2], a[3]);
        *reinterpret_cast<float4*>(t_ends + at) = make_float4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<uint32_t*>(mask + at) = valid ? 0x01010101u : 0u;
      }
    } else {
      // round s0's columns W at a time: column c of the round is slot c / k's
      for (int c0 = 0; c0 < W * P.k; c0 += W) {
        const int c = c0 + lane, from = c / P.k, q = c - from * P.k;
        const float ts_c = __shfl_sync(kFull, ts, from, W);
        const float dt_c = __shfl_sync(kFull, dt_sel, from, W);
        const bool valid_c = __shfl_sync(kFull, static_cast<int>(valid), from, W) != 0;
        const int col = s0 * P.k + c;
        if (live && col < S) {
          float t_start, t_end;
          fine_column(P, ts_c, dt_c, q, t_start, t_end);
          t_starts[base + col] = valid_c ? t_start : 0.0f;
          t_ends[base + col] = valid_c ? t_end : 0.0f;
          mask[base + col] = valid_c;
        }
      }
    }
  }
  if (live && lane == 0) num_samples[r] = budget * P.k;
}

// More than 32 fine or pre-pass words a stage: K5's WIDE kernels.
__host__ __device__ __forceinline__ bool wide_words(const MarchParams& P) {
  return P.words_fine > 32 || P.words_pre > 32;
}

// The routes the launchers report (umhs_torch/ops/ray_marching.py's
// MARCH_ROUTES): a word a lane, or the WIDE kernels.
constexpr int32_t kRouteLanes = 0, kRouteWide = 1;

// K5b's launch: W 16 where a ray's slots and words fit half a warp; *route
// the route launched (kRouteLanes or kRouteWide).
template <int K>
cudaError_t launch_emit(const MarchParams& P, const int32_t* state, const int32_t* total,
                        float* t_starts, float* t_ends, uint8_t* mask, int32_t* num_samples,
                        cudaStream_t stream, int32_t* route) {
  const bool half = P.Sc <= 16 && P.words_fine <= 16 && P.words_pre <= 16;
  *route = !half && wide_words(P) ? kRouteWide : kRouteLanes;
  const int per_block = kWarps * (half ? 2 : 1);
  const int blocks = (P.R + per_block - 1) / per_block;
  if (half) {
    march_emit_kernel<K, 16, false><<<blocks, kWarps * 32, 0, stream>>>(
        P, state, total, t_starts, t_ends, mask, num_samples);
  } else if (!wide_words(P)) {
    march_emit_kernel<K, 32, false><<<blocks, kWarps * 32, 0, stream>>>(
        P, state, total, t_starts, t_ends, mask, num_samples);
  } else {
    march_emit_kernel<K, 32, true><<<blocks, kWarps * 32, 0, stream>>>(
        P, state, total, t_starts, t_ends, mask, num_samples);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int umhs_march_params_size() { return static_cast<int>(sizeof(MarchParams)); }

extern "C" int umhs_march_count(const MarchParams* params, const float* origins,
                                const float* dirs, const float* jitter, const int64_t* packed,
                                const uint8_t* binaries, const uint8_t* pooled,
                                const float* occs_low, int32_t* state, int32_t* total,
                                int32_t* num_occupied, cudaStream_t stream, int32_t* route) {
  const MarchParams P = *params;
  const int blocks = (P.R + kCountWarps - 1) / kCountWarps;
  *route = wide_words(P) ? kRouteWide : kRouteLanes;
  if (wide_words(P))
    march_count_kernel<true><<<blocks, kCountWarps * 32, 0, stream>>>(
        P, origins, dirs, jitter, packed, binaries, pooled, occs_low, state, total, num_occupied);
  else
    march_count_kernel<false><<<blocks, kCountWarps * 32, 0, stream>>>(
        P, origins, dirs, jitter, packed, binaries, pooled, occs_low, state, total, num_occupied);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int umhs_march_emit(const MarchParams* params, const int32_t* state,
                               const int32_t* total, float* t_starts, float* t_ends,
                               uint8_t* mask, int32_t* num_samples, cudaStream_t stream,
                               int32_t* route) {
  const MarchParams P = *params;
  return static_cast<int>(
      P.k == 4
          ? launch_emit<4>(P, state, total, t_starts, t_ends, mask, num_samples, stream, route)
          : launch_emit<0>(P, state, total, t_starts, t_ends, mask, num_samples, stream, route));
}
