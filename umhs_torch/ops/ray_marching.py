"""Fixed-shape occupancy-grid ray marching (port of umhs_tpu/ops/ray_marching.py).

1. Candidates: each ray gets closed-form interval starts t_k on nerfacc's
   step schedule dt_k = max(t_k * cone_angle, render_step_size), linear until
   t reaches render_step_size / cone_angle and geometric after.
2. Compaction: the occupancy grid is queried at candidate midpoints and the
   occupied candidates are compacted to S slots per ray by a budgeted rank
   select; a ray (or batch) over budget keeps an even stride of its occupied
   candidates with dt scaled up so optical depth is conserved.

With a pool factor, a pre-pass marches supercell-sized steps against the
pooled grid and only the first `supers` occupied supercells are subdivided
into cell candidates. Occupancy is queried once per `occ_subsamples` fine
steps, and each kept interval is split into that many fine samples.
The output is a fixed (R, S) block of [t_start, t_end] intervals and a mask.

K5, the march on the card (``csrc/march.cu``, port of the XLA code of
umhs_tpu/ops/ray_marching.py:250 `march_rays`): K5a `umhs_march_count` walks
each ray's candidates to their occupancy bits and adds the ray's budget to
a batch total on the device; K5b `umhs_march_emit` rank-selects under the
batch's budget, a lane a slot, and writes the intervals. impl="auto"
launches them on a CUDA tensor, the plain version runs on a CPU tensor or
with impl="plain"; both give the same bits, but for the od culling, which
sums in another order (it is off in every shipped configuration).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ._native import Kernel
from .compact import _check_impl, _stream
from .occupancy import (
    OccGridConfig,
    OccParams,
    check_grid_limits,
    occ_params,
    query_grid_values,
    query_occupancy,
    query_packed_occupancy,
    query_packed_supercell,
)


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    num_candidates: int = 1024
    num_samples: int = 96
    render_step_size: float = 3.4641016e-3
    cone_angle: float = 0.004
    near_plane: float = 0.05
    far_plane: float = 1.0e3
    occ_subsamples: int = 1
    pool: int = 0
    pool_supers: int = 0  # 0 = auto (2x coarse_samples)
    # approximate early termination on the occupancy state's lower-envelope
    # optical depth; 0 disables
    early_stop_od: float = 0.0

    @property
    def coarse_candidates(self) -> int:
        return self.num_candidates // max(self.occ_subsamples, 1)

    @property
    def coarse_samples(self) -> int:
        return self.num_samples // max(self.occ_subsamples, 1)

    @property
    def supers(self) -> int:
        return self.pool_supers or min(2 * self.coarse_samples,
                                       max(self.coarse_candidates // self.pool, 1))


def _super_config(march: MarchConfig) -> MarchConfig:
    """The pre-pass's supercell schedule (pool p, occ_subsamples k)."""
    k, p = max(march.occ_subsamples, 1), march.pool
    return dataclasses.replace(
        march,
        num_candidates=max(march.coarse_candidates // p, 1),
        render_step_size=march.render_step_size * k * p,
        cone_angle=march.cone_angle * k * p,
    )


def _coarse_config(march: MarchConfig) -> MarchConfig:
    """The coarse candidates' schedule without a pre-pass."""
    k = max(march.occ_subsamples, 1)
    return dataclasses.replace(
        march,
        num_candidates=march.coarse_candidates,
        render_step_size=march.render_step_size * k,
        cone_angle=march.cone_angle * k,
    )


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def ray_aabb_intersect(origins, directions, aabb_min, aabb_max):
    """Slab test: (t_min, t_max) per ray; t_min > t_max means no hit."""
    lo = torch.as_tensor(aabb_min, dtype=origins.dtype, device=origins.device)
    hi = torch.as_tensor(aabb_max, dtype=origins.dtype, device=origins.device)
    safe = torch.where(torch.abs(directions) > 1e-10, directions,
                       torch.full_like(directions, 1e-10))
    inv = 1.0 / safe
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    t_min = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_max = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_min, t_max


def _schedule(t0: torch.Tensor, march: MarchConfig, k: torch.Tensor):
    """(t, dt) of candidate indices k (f32, broadcast against t0 (R, 1))."""
    dt0 = march.render_step_size
    cone = march.cone_angle
    if cone <= 0.0:
        ts = t0 + k * dt0
        return ts, torch.full_like(ts, dt0)
    t_crit = dt0 / cone
    k_crit = torch.ceil(torch.clamp_min(t_crit - t0, 0.0) / dt0)
    t_lin = t0 + k * dt0
    t_at_crit = t0 + k_crit * dt0
    growth = torch.log1p(torch.tensor(cone, dtype=torch.float32, device=t0.device))
    t_exp = t_at_crit * torch.exp((k - k_crit) * growth)
    ts = torch.where(k < k_crit, t_lin, t_exp)
    dts = torch.clamp_min(ts * cone, dt0)
    return ts, dts


def candidate_ts(t0: torch.Tensor, march: MarchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t_starts, dts), each (R, num_candidates), from per-ray start t0 (R,)."""
    k = torch.arange(march.num_candidates, dtype=torch.float32, device=t0.device)[None, :]
    return _schedule(t0[:, None], march, k)


def _ts_at_index(t0: torch.Tensor, march: MarchConfig, kidx: torch.Tensor):
    """(t, dt) at candidate indices kidx (R, S): candidate_ts' formulas."""
    return _schedule(t0[:, None], march, kidx.float())


def _rank_select(
    occupied: torch.Tensor,
    ts: torch.Tensor,
    dts: torch.Tensor,
    S: int,
    total_budget: Optional[int] = None,
    schedule: Optional[Tuple[torch.Tensor, MarchConfig]] = None,
):
    """Budgeted compaction of occupied candidates (R, M) to S slots per ray.

    A ray with more occupied candidates than its budget keeps an even stride
    over all of them with dt scaled by count/budget; `total_budget` scales
    every ray's budget down so the batch stays within it. Slot s holds the
    candidate of occupied rank target(s). Returns (t_starts, dt, valid), (R, S).
    """
    M = occupied.shape[-1]
    cum = torch.cumsum(occupied.int(), dim=-1, dtype=torch.int32)  # (R, M)
    count = cum[:, -1:]  # (R, 1)
    budget = torch.clamp_max(count, S)
    if total_budget is not None:
        total = torch.clamp_min(budget.sum(), 1).float()
        # one rounding, as the JAX package divides (a Python number over a
        # tensor takes the reciprocal first and multiplies: two roundings)
        scale = torch.clamp_max(torch.div(torch.full_like(total, total_budget), total), 1.0)
        budget = torch.maximum((budget.float() * scale).int(), torch.clamp_max(count, 1))
    slot = torch.arange(S, dtype=torch.int32, device=occupied.device)[None, :]
    rank = torch.where(count > budget, (slot * count) // torch.clamp_min(budget, 1), slot)
    valid = slot < budget
    # first candidate whose running count reaches rank + 1
    idx = torch.searchsorted(cum.contiguous(), (rank + 1).contiguous(), side="left")
    idx = torch.clamp_max(idx, M - 1)
    dt_scale = torch.clamp_min(count.float() / torch.clamp_min(budget, 1).float(), 1.0)
    if schedule is not None:
        t_starts, dt_sel = _ts_at_index(schedule[0], schedule[1], idx)
        dt_sel = dt_sel * dt_scale
    else:
        t_starts = torch.gather(ts, 1, idx)
        dt_sel = torch.gather(dts, 1, idx) * dt_scale
    zero = torch.zeros((), dtype=t_starts.dtype, device=t_starts.device)
    return torch.where(valid, t_starts, zero), torch.where(valid, dt_sel, zero), valid


def march_rays(
    occ_state,
    occ_config: OccGridConfig,
    march: MarchConfig,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_jitter: Optional[torch.Tensor] = None,
    total_budget: Optional[int] = None,
    early_stop_od_value: Optional[float] = None,
    impl: str = "auto",
):
    """March rays (R, 3) through the occupancy grid `occ_state`.

    t_jitter: optional (R,) in [0, 1) shifting each ray's start by
        jitter * render_step_size (training); None for the deterministic
        eval march.
    total_budget: optional cap on the batch's total number of samples.
    early_stop_od_value: override of march.early_stop_od.
    impl: "auto" launches K5 on a CUDA tensor and runs the plain version on
        a CPU tensor; "plain" runs the plain version anywhere.

    Returns t_starts, t_ends, mask (R, S), num_samples and num_occupied (R,).
    """
    _check_impl(impl)
    fn = march_rays_plain if impl == "plain" or origins.device.type == "cpu" else march_rays_cuda
    return fn(occ_state, occ_config, march, origins, directions, t_jitter, total_budget,
              early_stop_od_value)


def march_rays_plain(
    occ_state,
    occ_config: OccGridConfig,
    march: MarchConfig,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_jitter: Optional[torch.Tensor] = None,
    total_budget: Optional[int] = None,
    early_stop_od_value: Optional[float] = None,
):
    """Plain version of K5 (march_rays' arguments but impl)."""
    c = march_candidates_plain(occ_state, occ_config, march, origins, directions, t_jitter)
    ts, dts, positions, occupied = c["ts"], c["dts"], c["positions"], c["occupied"]
    k = max(march.occ_subsamples, 1)
    R = origins.shape[0]

    if march.early_stop_od > 0.0:
        # optical depth from the lower-envelope density * step per cell;
        # candidates behind an opaque-enough prefix are dropped
        vals, _ = query_grid_values(occ_state["occs_low"], positions, occ_config)
        contrib = torch.where(occupied, vals, torch.zeros_like(vals)) * (
            dts / march.render_step_size)
        od = torch.cumsum(contrib, dim=-1) - contrib
        od_max = march.early_stop_od if early_stop_od_value is None else early_stop_od_value
        occupied = occupied & (od < od_max)

    t_starts, dt_sel, valid = _rank_select(
        occupied, ts, dts, march.coarse_samples,
        total_budget // k if total_budget is not None else None,
        schedule=c["fine_schedule"],
    )

    if k > 1:
        sub = torch.arange(k, dtype=torch.float32, device=ts.device)[None, None, :]
        dt_fine = (dt_sel / k)[:, :, None]  # (R, Sc, 1)
        t_f = t_starts[:, :, None] + sub * dt_fine  # (R, Sc, k)
        valid = valid.repeat_interleave(k, dim=1)
        zero = torch.zeros((), dtype=t_f.dtype, device=t_f.device)
        t_ends = torch.where(valid, (t_f + dt_fine).reshape(R, -1), zero)
        t_starts = torch.where(valid, t_f.reshape(R, -1), zero)
    else:
        t_ends = t_starts + dt_sel

    return {
        "t_starts": t_starts,
        "t_ends": t_ends,
        "mask": valid,
        "num_samples": valid.sum(dim=-1, dtype=torch.int32),
        # occupied candidates per ray before the budget (fine-sample units)
        "num_occupied": occupied.sum(dim=-1, dtype=torch.int32) * k,
    }


def march_candidates_plain(occ_state, occ_config: OccGridConfig, march: MarchConfig,
                           origins: torch.Tensor, directions: torch.Tensor,
                           t_jitter: Optional[torch.Tensor] = None):
    """The plain march up to the od culling: each ray's cell candidates
    {"ts", "dts", "positions", "occupied"} (R, M) and the schedule that
    recomputes them ("fine_schedule", None after a pre-pass)."""
    directions = _unit(directions)
    big_half = occ_config.max_scale
    aabb_min = occ_config.center - occ_config.half_extent * big_half
    aabb_max = occ_config.center + occ_config.half_extent * big_half
    t_enter, t_exit = ray_aabb_intersect(origins, directions, aabb_min, aabb_max)
    t_min = torch.clamp_min(t_enter, march.near_plane)
    t_max = torch.clamp_max(t_exit, march.far_plane)
    t0 = t_min if t_jitter is None else t_min + t_jitter * march.render_step_size

    R = origins.shape[0]
    packed = occ_state.get("packed_words") if march.early_stop_od <= 0.0 else None
    pooled = occ_state.get("binaries_pooled")

    def points(ts, dts):
        mids = ts + dts / 2.0
        return origins[:, None, :] + directions[:, None, :] * mids[..., None]

    if march.pool > 1 and pooled is not None:
        p = march.pool
        superA = _super_config(march)
        tsA, dtsA = candidate_ts(t0, superA)  # (R, Ma)
        in_rangeA = tsA < t_max[:, None]
        posA = points(tsA, dtsA)
        if packed is not None and p == 4:
            occA = query_packed_supercell(packed, posA, occ_config) & in_rangeA
        else:
            occA = query_occupancy(pooled, posA, occ_config,
                                   res=occ_config.resolution // p) & in_rangeA
        tA, dtA, validA = _rank_select(occA, tsA, dtsA, march.supers, schedule=(t0, superA))
        # subdivide each kept supercell interval into p cell intervals
        sub = torch.arange(p, dtype=torch.float32, device=t0.device)[None, None, :]
        dt_cell = (dtA / p)[:, :, None]  # (R, SA, 1)
        ts = (tA[:, :, None] + sub * dt_cell).reshape(R, -1)
        dts = dt_cell.expand(*dtA.shape, p).reshape(R, -1)
        in_range = validA.repeat_interleave(p, dim=1)
        fine_schedule = None
    else:
        coarse = _coarse_config(march)
        ts, dts = candidate_ts(t0, coarse)  # (R, Mc)
        in_range = ts < t_max[:, None]
        fine_schedule = (t0, coarse)

    positions = points(ts, dts)
    if packed is not None:
        occupied = query_packed_occupancy(packed, positions, occ_config) & in_range
    else:
        occupied = query_occupancy(occ_state["binaries"], positions, occ_config) & in_range
    return {"ts": ts, "dts": dts, "positions": positions, "occupied": occupied,
            "fine_schedule": fine_schedule}


class Schedule(ctypes.Structure):
    """One candidate schedule's constants (csrc/march.cu `Schedule`)."""

    _fields_ = [("dt0", ctypes.c_float), ("cone", ctypes.c_float), ("inv_dt0", ctypes.c_float),
                ("t_crit", ctypes.c_float), ("growth", ctypes.c_float),
                ("linear", ctypes.c_int32)]


class MarchParams(ctypes.Structure):
    """K5's constants, passed by value (csrc/march.cu `MarchParams`)."""

    _fields_ = [
        ("grid", OccParams),
        ("R", ctypes.c_int32), ("M", ctypes.c_int32), ("Ma", ctypes.c_int32),
        ("Sc", ctypes.c_int32), ("supers", ctypes.c_int32), ("k", ctypes.c_int32),
        ("pool", ctypes.c_int32), ("pre_mode", ctypes.c_int32), ("fine_mode", ctypes.c_int32),
        ("od", ctypes.c_int32), ("has_budget", ctypes.c_int32), ("total_budget", ctypes.c_int32),
        ("words_fine", ctypes.c_int32), ("words_pre", ctypes.c_int32), ("width", ctypes.c_int32),
        ("lo", ctypes.c_float * 3), ("hi", ctypes.c_float * 3), ("tiny", ctypes.c_float),
        ("near_plane", ctypes.c_float), ("far_plane", ctypes.c_float),
        ("jitter_step", ctypes.c_float), ("inv_p", ctypes.c_float), ("inv_k", ctypes.c_float),
        ("od_inv_step", ctypes.c_float), ("od_max", ctypes.c_float),
        ("pre", Schedule), ("coarse", Schedule),
    ]


_P = ctypes.c_void_p
MARCH_COUNT = Kernel("march.cu", "umhs_march_count", [_P] * 13)
MARCH_EMIT = Kernel("march.cu", "umhs_march_emit", [_P] * 9)
MARCH_ROUTES = ("lanes", "wide")  # the launchers' kRouteLanes, kRouteWide (csrc/march.cu)
PRE_NONE, QUERY_PACKED, QUERY_BYTES = 0, 1, 2


def _f32_reciprocal(x: float) -> float:
    """1 / x as PyTorch's CUDA division by a Python number x rounds it (in
    float32, then multiplied)."""
    return float(np.float32(1.0) / np.float32(x))


@functools.lru_cache(maxsize=None)
def _growth(cone: float, device: torch.device) -> float:
    """log1p(cone) as the plain version computes it, on the card, read back
    once per cone and device."""
    return float(torch.log1p(torch.tensor(cone, dtype=torch.float32, device=device)))


def _schedule_params(sched: MarchConfig, device: torch.device) -> Schedule:
    dt0, cone = sched.render_step_size, sched.cone_angle
    if cone <= 0.0:
        return Schedule(dt0=dt0, cone=0.0, inv_dt0=_f32_reciprocal(dt0), t_crit=0.0, growth=0.0,
                        linear=1)
    return Schedule(dt0=dt0, cone=cone, inv_dt0=_f32_reciprocal(dt0), t_crit=dt0 / cone,
                    growth=_growth(float(np.float32(cone)), device), linear=0)


def march_layout(occ_state, occ_config: OccGridConfig, march: MarchConfig):
    """(pre-pass query, fine query, pre-pass candidates Ma, fine candidates
    M) of a march, as the plain version chooses: the pre-pass with pool > 1
    and a pooled bitfield (the packed words' supercells with pool 4, else
    the pooled bytes), the fine query from the packed words unless od
    culling is on, else from the bytes. Raises where the JAX package's
    MarchConfig asserts (candidates or samples not a multiple of
    occ_subsamples), where a stage has no candidate or a ray no slot, and
    where the kernels' int32 candidate, rank or sample counts would
    overflow."""
    k = max(march.occ_subsamples, 1)
    if march.num_candidates % k or march.num_samples % k:
        raise ValueError(f"march_rays_cuda: {march.num_candidates} candidates and "
                         f"{march.num_samples} samples must be multiples of occ_subsamples {k} "
                         "(the JAX package's MarchConfig asserts it)")
    packed = "packed_words" in occ_state and march.early_stop_od <= 0.0
    if march.pool > 1 and "binaries_pooled" in occ_state:
        pre = QUERY_PACKED if packed and march.pool == 4 else QUERY_BYTES
        Ma, M = _super_config(march).num_candidates, march.supers * march.pool
    else:
        pre, Ma, M = PRE_NONE, 0, march.coarse_candidates
    fine = QUERY_PACKED if packed else QUERY_BYTES
    Sc = march.coarse_samples
    if M < 1 or Sc < 1:
        raise ValueError(f"march_rays_cuda: {M} fine candidates and {Sc} slots a ray: a stage "
                         "needs at least one candidate and a ray one slot")
    supers = march.supers if pre != PRE_NONE else 0
    if (max(M, Ma) + 32 > 2**31 or Sc * M >= 2**31 or (supers + 32) * Ma >= 2**31
            or M * k >= 2**31):
        raise ValueError(f"march_rays_cuda: {M} fine and {Ma} pre-pass candidates a ray, {Sc} "
                         f"slots of {k} samples, are beyond the kernels' int32 candidate "
                         "indices, slot ranks (slots x candidates, in both passes) and sample "
                         "counts")
    check_grid_limits(occ_config, "march_rays_cuda")
    return pre, fine, Ma, M


def march_rays_cuda(
    occ_state,
    occ_config: OccGridConfig,
    march: MarchConfig,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_jitter: Optional[torch.Tensor] = None,
    total_budget: Optional[int] = None,
    early_stop_od_value: Optional[float] = None,
):
    """K5 on the card: march_rays' outputs from two launches, K5a
    (march_count_cuda: the candidates' occupancy bits a ray, its count and
    the batch's total of budgets on the device) and K5b (march_emit_cuda:
    the budgeted rank-select and the intervals)."""
    return march_emit_cuda(march_count_cuda(occ_state, occ_config, march, origins, directions,
                                            t_jitter, total_budget, early_stop_od_value))


@dataclasses.dataclass
class MarchPass:
    """K5a's results for K5b: the constants, each ray's state row (t0, count,
    the pre-pass's count, the fine and pre-pass words: 3 + ceil(M / 32) +
    ceil(Ma / 32) int32), the batch's total on the device and
    num_occupied."""

    params: MarchParams
    state: torch.Tensor
    total: torch.Tensor
    num_occupied: torch.Tensor
    samples: int


def march_count_cuda(
    occ_state,
    occ_config: OccGridConfig,
    march: MarchConfig,
    origins: torch.Tensor,
    directions: torch.Tensor,
    t_jitter: Optional[torch.Tensor] = None,
    total_budget: Optional[int] = None,
    early_stop_od_value: Optional[float] = None,
) -> MarchPass:
    """K5a (march_rays' arguments). The directions are made unit by the same
    PyTorch ops as the plain version's; every other step is the kernels'."""
    pre, fine, Ma, M = march_layout(occ_state, occ_config, march)
    dev = origins.device
    R = origins.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"march_rays_cuda: needs a CUDA tensor, not {dev}")
    for name, t, shape in (("origins", origins, (R, 3)), ("directions", directions, (R, 3)),
                           ("t_jitter", t_jitter, (R,))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape
                              or t.device != dev):
            raise ValueError(f"march_rays_cuda: {name} must be {shape} float32 on {dev}")
    k = max(march.occ_subsamples, 1)
    S = march.coarse_samples * k
    if not 0 < R < 2**31 // max(S, 64):
        raise ValueError(f"march_rays_cuda: {R} rays of {S} samples is beyond the kernel's "
                         "int32 ray index, or none")
    od = march.early_stop_od > 0.0
    budget = None if total_budget is None else total_budget // k
    if budget is not None and not 0 <= budget < 2**31:
        raise ValueError(f"march_rays_cuda: total_budget {total_budget} is beyond int32")
    wf, wa = (M + 31) // 32, (Ma + 31) // 32
    p = march.pool if pre != PRE_NONE else 1
    big_half = occ_config.max_scale
    aabb_min = occ_config.center - occ_config.half_extent * big_half
    aabb_max = occ_config.center + occ_config.half_extent * big_half
    params = MarchParams(
        grid=occ_params(occ_config), R=R, M=M, Ma=Ma, Sc=march.coarse_samples,
        supers=march.supers if pre != PRE_NONE else 0, k=k, pool=p, pre_mode=pre, fine_mode=fine, od=int(od),
        has_budget=int(budget is not None), total_budget=0 if budget is None else budget,
        words_fine=wf, words_pre=wa, width=3 + wf + wa,
        lo=(ctypes.c_float * 3)(*aabb_min.tolist()), hi=(ctypes.c_float * 3)(*aabb_max.tolist()),
        tiny=1e-10, near_plane=march.near_plane, far_plane=march.far_plane,
        jitter_step=march.render_step_size, inv_p=_f32_reciprocal(p), inv_k=_f32_reciprocal(k),
        od_inv_step=_f32_reciprocal(march.render_step_size),
        od_max=march.early_stop_od if early_stop_od_value is None else early_stop_od_value,
        pre=_schedule_params(_super_config(march), dev) if pre != PRE_NONE else Schedule(),
        coarse=_schedule_params(_coarse_config(march), dev) if pre == PRE_NONE else Schedule(),
    )

    def grid(key, dtype):
        t = occ_state[key]
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"march_rays_cuda: occ_state[{key!r}] must be a contiguous {dtype} "
                             f"tensor on {dev}")
        return t.data_ptr()

    packed = grid("packed_words", torch.int64) if QUERY_PACKED in (pre, fine) else None
    binaries = grid("binaries", torch.bool) if fine == QUERY_BYTES else None
    pooled = grid("binaries_pooled", torch.bool) if pre == QUERY_BYTES else None
    occs_low = grid("occs_low", torch.float32) if od else None
    o = origins.contiguous()
    d = _unit(directions).contiguous()
    jit = None if t_jitter is None else t_jitter.contiguous()
    out = MarchPass(params, torch.empty((R, params.width), dtype=torch.int32, device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev),
                    torch.empty(R, dtype=torch.int32, device=dev), S)
    MARCH_COUNT.check_struct("umhs_march_params_size", MarchParams)
    with torch.cuda.device(dev):
        MARCH_COUNT.launch(ctypes.byref(params), o.data_ptr(), d.data_ptr(),
                           None if jit is None else jit.data_ptr(), packed, binaries, pooled,
                           occs_low, out.state.data_ptr(), out.total.data_ptr(),
                           out.num_occupied.data_ptr(), _stream(o), routes=MARCH_ROUTES)
    return out


def march_emit_cuda(p: MarchPass):
    """K5b: march_rays' outputs from K5a's pass."""
    R, S, dev = p.params.R, p.samples, p.state.device
    out = {
        "t_starts": torch.empty((R, S), dtype=torch.float32, device=dev),
        "t_ends": torch.empty((R, S), dtype=torch.float32, device=dev),
        "mask": torch.empty((R, S), dtype=torch.bool, device=dev),
        "num_samples": torch.empty(R, dtype=torch.int32, device=dev),
        "num_occupied": p.num_occupied,
    }
    with torch.cuda.device(dev):
        MARCH_EMIT.launch(ctypes.byref(p.params), p.state.data_ptr(), p.total.data_ptr(),
                          out["t_starts"].data_ptr(), out["t_ends"].data_ptr(),
                          out["mask"].data_ptr(), out["num_samples"].data_ptr(), _stream(p.state),
                          routes=MARCH_ROUTES)
    return out


def sample_positions(origins, directions, t_starts, t_ends) -> torch.Tensor:
    """Midpoint world positions of sample intervals: (R, S, 3)."""
    directions = _unit(directions)
    mids = (t_starts + t_ends) / 2.0
    return origins[:, None, :] + directions[:, None, :] * mids[..., None]
