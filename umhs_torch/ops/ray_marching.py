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
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .occupancy import (
    OccGridConfig,
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
        total = torch.clamp_min(budget.sum(), 1)
        scale = torch.clamp_max(total_budget / total.float(), 1.0)
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
):
    """March rays (R, 3) through the occupancy grid `occ_state`.

    t_jitter: optional (R,) in [0, 1) shifting each ray's start by
        jitter * render_step_size (training); None for the deterministic
        eval march.
    total_budget: optional cap on the batch's total number of samples.
    early_stop_od_value: override of march.early_stop_od.

    Returns t_starts, t_ends, mask (R, S), num_samples and num_occupied (R,).
    """
    directions = _unit(directions)
    big_half = occ_config.max_scale
    aabb_min = occ_config.center - occ_config.half_extent * big_half
    aabb_max = occ_config.center + occ_config.half_extent * big_half
    t_enter, t_exit = ray_aabb_intersect(origins, directions, aabb_min, aabb_max)
    t_min = torch.clamp_min(t_enter, march.near_plane)
    t_max = torch.clamp_max(t_exit, march.far_plane)
    t0 = t_min if t_jitter is None else t_min + t_jitter * march.render_step_size

    k = max(march.occ_subsamples, 1)
    R = origins.shape[0]
    packed = occ_state.get("packed_words") if march.early_stop_od <= 0.0 else None
    pooled = occ_state.get("binaries_pooled")

    def points(ts, dts):
        mids = ts + dts / 2.0
        return origins[:, None, :] + directions[:, None, :] * mids[..., None]

    if march.pool > 1 and pooled is not None:
        p = march.pool
        superA = dataclasses.replace(
            march,
            num_candidates=max(march.coarse_candidates // p, 1),
            render_step_size=march.render_step_size * k * p,
            cone_angle=march.cone_angle * k * p,
        )
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
        coarse = dataclasses.replace(
            march,
            num_candidates=march.coarse_candidates,
            render_step_size=march.render_step_size * k,
            cone_angle=march.cone_angle * k,
        )
        ts, dts = candidate_ts(t0, coarse)  # (R, Mc)
        in_range = ts < t_max[:, None]
        fine_schedule = (t0, coarse)

    positions = points(ts, dts)
    if packed is not None:
        occupied = query_packed_occupancy(packed, positions, occ_config) & in_range
    else:
        occupied = query_occupancy(occ_state["binaries"], positions, occ_config) & in_range

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
        schedule=fine_schedule,
    )

    if k > 1:
        sub = torch.arange(k, dtype=torch.float32, device=t0.device)[None, None, :]
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


def sample_positions(origins, directions, t_starts, t_ends) -> torch.Tensor:
    """Midpoint world positions of sample intervals: (R, S, 3)."""
    directions = _unit(directions)
    mids = (t_starts + t_ends) / 2.0
    return origins[:, None, :] + directions[:, None, :] * mids[..., None]
