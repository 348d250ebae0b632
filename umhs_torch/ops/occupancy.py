"""Multi-level binary occupancy grid (port of umhs_tpu/ops/occupancy.py).

The grid is a dict of flat tensors: the EMA densities ``occs`` and their
lower envelope ``occs_low`` (levels * res^3,), the bitfield ``binaries``,
the max-pooled bitfield ``binaries_pooled`` when pool > 1, and when res % 4
== 0 the packed supercell words ``packed_words``: each 4^3-cell supercell's
occupancy as one 64-bit word, stored as [lo, hi] uint32 halves in an int64
tensor (torch's uint32 support is thin). Level i covers the level-0 box
scaled by 2^i; a position is looked up in the finest level containing it.

`update_occ_state` is the EMA update: full (every cell of every level) or
partial (sampled cells, as the trainer runs after warmup). Every random
draw is an argument: the in-cell jitter, and for the partial update the
cells' draws (`draw_partial_cells` makes them from a torch.Generator, a
test from the JAX key splits). `occ_update_due` is nerfacc's schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class OccGridConfig:
    resolution: int = 128
    levels: int = 4
    aabb_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    aabb_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ema_decay: float = 0.95
    occ_thre: float = 0.01
    warmup_steps: int = 256
    update_interval: int = 16
    # during warmup every k-th due update is full, the others partial
    # (1 = nerfacc's schedule: every warmup update is full)
    warmup_full_every: int = 1
    # partial update: cells sampled per update, as a fraction of res^3, at
    # level 0 and at the outer levels (0 = sample_fraction)
    sample_fraction: float = 0.25
    outer_sample_fraction: float = 0.0625
    # max-pool factor of the march pre-pass bitfield (0 disables)
    pool: int = 0

    @property
    def cells_per_level(self) -> int:
        return self.resolution**3

    @property
    def center(self) -> np.ndarray:
        return (np.asarray(self.aabb_min, np.float32) + np.asarray(self.aabb_max, np.float32)) / 2.0

    @property
    def half_extent(self) -> np.ndarray:
        """Half side of the level-0 box."""
        return (np.asarray(self.aabb_max, np.float32) - np.asarray(self.aabb_min, np.float32)) / 2.0

    @property
    def max_scale(self) -> float:
        return float(2 ** (self.levels - 1))


def _pool_binaries(binaries: torch.Tensor, config: OccGridConfig) -> torch.Tensor:
    """A supercell of pool^3 cells is occupied iff any of its cells is."""
    p, r, L = config.pool, config.resolution, config.levels
    b = binaries.reshape(L, r // p, p, r // p, p, r // p, p)  # (L, Z, z, Y, y, X, x)
    return b.any(dim=6).any(dim=4).any(dim=2).reshape(-1)


def _pack_supercell_words(binaries: torch.Tensor, config: OccGridConfig) -> torch.Tensor:
    """Flat (L * (r/4)^3 * 2,) int64 [lo, hi] words; bit sx + 4*sy + 16*sz
    holds cell (sx, sy, sz) of the supercell (x-minor, like the cell index)."""
    r, L = config.resolution, config.levels
    r4 = r // 4
    b = binaries.reshape(L, r4, 4, r4, 4, r4, 4)  # (L, Z, sz, Y, sy, X, sx)
    bits = b.permute(0, 1, 3, 5, 2, 4, 6).reshape(L, r4, r4, r4, 64).long()
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    lo = (bits[..., :32] * weights).sum(-1)
    hi = (bits[..., 32:] * weights).sum(-1)
    return torch.stack([lo, hi], dim=-1).reshape(-1)


def init_occ_state(config: OccGridConfig, device="cpu"):
    n = config.levels * config.cells_per_level
    state = {
        "occs": torch.zeros((n,), dtype=torch.float32, device=device),
        # lower envelope of the same probes: a per-cell lower bound on
        # density * step, used by the march's optional od culling
        "occs_low": torch.zeros((n,), dtype=torch.float32, device=device),
        "binaries": torch.zeros((n,), dtype=torch.bool, device=device),
    }
    if config.pool > 1:
        if config.resolution % config.pool:
            raise ValueError("grid resolution must be divisible by the pool factor")
        np_ = config.levels * (config.resolution // config.pool) ** 3
        state["binaries_pooled"] = torch.zeros((np_,), dtype=torch.bool, device=device)
    if config.resolution % 4 == 0:
        ns = config.levels * (config.resolution // 4) ** 3
        state["packed_words"] = torch.zeros((ns * 2,), dtype=torch.int64, device=device)
    return state


def _level_world_positions(
    config: OccGridConfig, level: torch.Tensor, cell_flat: torch.Tensor, jitter: torch.Tensor
) -> torch.Tensor:
    """World position of a jittered point inside (level, cell)."""
    res = config.resolution
    ijk = torch.stack(
        [cell_flat % res, (cell_flat // res) % res, cell_flat // (res * res)], dim=-1
    )
    unit = (ijk.float() / res + jitter / res) * 2.0 - 1.0  # [-1, 1]
    scale = torch.exp2(level.float())[..., None]
    center = torch.as_tensor(config.center, device=jitter.device)
    half = torch.as_tensor(config.half_extent, device=jitter.device)
    return center + unit * half * scale


def _level_and_unit(positions: torch.Tensor, config: OccGridConfig):
    """(finest containing level, position in that level's [0, 1]^3, inside)."""
    center = torch.as_tensor(config.center, device=positions.device)
    half = torch.as_tensor(config.half_extent, device=positions.device)
    rel = (positions - center) / half  # level-0 normalised coords
    maxc = torch.amax(torch.abs(rel), dim=-1)
    lvl = torch.ceil(torch.log2(torch.clamp_min(maxc, 1e-12)))
    lvl = torch.clamp(lvl, 0, config.levels - 1).long()
    inside = maxc <= config.max_scale
    scale = torch.exp2(lvl.float())[..., None]
    unit = (rel / scale + 1.0) / 2.0
    return lvl, unit, inside


def query_grid_values(
    grid: torch.Tensor,
    positions: torch.Tensor,
    config: OccGridConfig,
    res: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, inside) of a flat per-level grid at world positions (..., 3);
    `res` overrides the per-level resolution (for the pooled bitfield)."""
    lvl, unit, inside = _level_and_unit(positions, config)
    res = config.resolution if res is None else res
    ijk = torch.clamp(torch.floor(unit * res).long(), 0, res - 1)
    flat = lvl * (res**3) + ijk[..., 0] + ijk[..., 1] * res + ijk[..., 2] * res * res
    return grid[flat], inside


def query_occupancy(
    binaries: torch.Tensor, positions: torch.Tensor, config: OccGridConfig,
    res: Optional[int] = None,
) -> torch.Tensor:
    occ, inside = query_grid_values(binaries, positions, config, res=res)
    return occ & inside


def _packed_cell_index(positions: torch.Tensor, config: OccGridConfig):
    """(supercell row, bit 0..63, inside) of world positions at cell
    resolution; same level choice and clipping as query_grid_values."""
    lvl, unit, inside = _level_and_unit(positions, config)
    res = config.resolution
    r4 = res // 4
    ijk = torch.clamp(torch.floor(unit * res).long(), 0, res - 1)
    sc, sub = ijk >> 2, ijk & 3
    flat = lvl * (r4**3) + sc[..., 0] + sc[..., 1] * r4 + sc[..., 2] * r4 * r4
    bit = sub[..., 0] + (sub[..., 1] << 2) + (sub[..., 2] << 4)
    return flat, bit, inside


def query_packed_occupancy(
    packed_words: torch.Tensor, positions: torch.Tensor, config: OccGridConfig
) -> torch.Tensor:
    """Cell occupancy from the packed words (equal to query_occupancy)."""
    flat, bit, inside = _packed_cell_index(positions, config)
    rows = packed_words.reshape(-1, 2)[flat]
    word = torch.where(bit < 32, rows[..., 0], rows[..., 1])
    return (((word >> (bit & 31)) & 1) == 1) & inside


def query_packed_supercell(
    packed_words: torch.Tensor, positions: torch.Tensor, config: OccGridConfig
) -> torch.Tensor:
    """Supercell occupancy (any of its 4^3 cells) from the packed words
    (equal to query_occupancy(binaries_pooled, ..., res=r/4))."""
    flat, _, inside = _packed_cell_index(positions, config)
    rows = packed_words.reshape(-1, 2)[flat]
    return ((rows[..., 0] | rows[..., 1]) != 0) & inside


def _eval_occ(
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    positions: torch.Tensor,
    chunk: int = 1 << 20,
) -> torch.Tensor:
    """Density at (N, 3) positions in chunks of `chunk` -> (N,)."""
    return torch.cat([density_fn(positions[i:i + chunk])
                      for i in range(0, positions.shape[0], chunk)])


def partial_sample_counts(config: OccGridConfig) -> List[Tuple[int, int]]:
    """(uniform, occupied) cell counts of the partial update, per level."""
    counts = []
    for lvl in range(config.levels):
        frac = config.sample_fraction if lvl == 0 else (
            config.outer_sample_fraction or config.sample_fraction)
        m = max(int(config.cells_per_level * frac), 2)
        counts.append((m - m // 2, m // 2))
    return counts


def draw_partial_cells(
    config: OccGridConfig, generator: torch.Generator, device
) -> List[Dict[str, torch.Tensor]]:
    """The partial update's draws per level: "uniform" cells (int64), the
    stratified-rank offsets "u" in [0, 1) and the "fallback" cells used when
    a level has no occupied cell."""
    res3 = config.cells_per_level
    draws = []
    for m_uni, m_occ in partial_sample_counts(config):
        draws.append({
            "uniform": torch.randint(0, res3, (m_uni,), generator=generator, device=device),
            "u": torch.rand((m_occ,), generator=generator, device=device),
            "fallback": torch.randint(0, res3, (m_occ,), generator=generator, device=device),
        })
    return draws


def partial_cells(
    state, config: OccGridConfig, draws: List[Dict[str, torch.Tensor]]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(level, cell) of the partial update from its draws
    (umhs_tpu/ops/occupancy.py:367-407): per level, half the cells uniform
    and half occupied ones, taken at stratified ranks (i + u_i) / m of the
    level's occupied count and inverted through the running count with
    searchsorted; a level with no occupied cell takes the fallback cells."""
    res3 = config.cells_per_level
    cum = torch.cumsum(state["binaries"].reshape(config.levels, res3).long(), dim=1)
    levels, cells = [], []
    for lvl, d in enumerate(draws):
        u = d["u"].float()
        m_occ = u.shape[0]
        count = cum[lvl, -1]
        strat = (torch.arange(m_occ, dtype=torch.float32, device=u.device) + u) / m_occ
        rank = torch.floor(strat * count.float()).long()
        occ_idx = torch.searchsorted(cum[lvl], rank, right=True)
        occ_idx = torch.where(count > 0, torch.clamp_max(occ_idx, res3 - 1), d["fallback"].long())
        c = torch.cat([d["uniform"].long(), occ_idx])
        cells.append(c)
        levels.append(torch.full_like(c, lvl))
    return torch.cat(levels), torch.cat(cells)


def update_occ_state(
    state,
    config: OccGridConfig,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    render_step_size: float,
    jitter: torch.Tensor,
    cells: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """One EMA update. Full when `cells` is None: every cell of every level
    is probed at the jittered point `jitter` (levels * res^3, 3) in [0, 1)^3
    inside it. Partial otherwise: the (level, cell) pairs `cells` (M,), e.g.
    from `partial_cells`, are probed at `jitter` (M, 3).

    occs <- max(occs * decay, density * step); the lower envelope drops to a
    lower probe at once and rises at most x2 per update (seeded at occ_thre);
    binaries = occs > min(mean(occs), occ_thre), then pooled and packed.

    Cells are drawn with replacement, so a partial update can probe one cell
    twice. The rule here, deterministic on every device: the largest probe
    wins in `occs` and the smallest in `occs_low` (the JAX package's
    scatter-set leaves the winner unspecified; the two agree on cells probed
    once)."""
    res3 = config.cells_per_level
    L = config.levels
    dev = jitter.device
    if cells is None:
        cell_flat = torch.arange(res3, device=dev).repeat(L)
        level = torch.arange(L, device=dev).repeat_interleave(res3)
    else:
        level, cell_flat = (c.long() for c in cells)
    positions = _level_world_positions(config, level, cell_flat, jitter)
    occ = _eval_occ(density_fn, positions) * render_step_size
    # a NaN would persist through the EMA max and silently empty the grid
    occ = torch.nan_to_num(occ)

    if cells is None:
        occs = torch.maximum(state["occs"] * config.ema_decay, occ)
        rise = torch.clamp_min(state["occs_low"] * 2.0, config.occ_thre)
        occs_low = torch.minimum(occ, rise)
    else:
        flat_idx = level * res3 + cell_flat
        new = torch.maximum(state["occs"][flat_idx] * config.ema_decay, occ)
        rise = torch.clamp_min(state["occs_low"][flat_idx] * 2.0, config.occ_thre)
        new_low = torch.minimum(occ, rise)
        occs = state["occs"].scatter_reduce(0, flat_idx, new, "amax", include_self=False)
        occs_low = state["occs_low"].scatter_reduce(0, flat_idx, new_low, "amin",
                                                    include_self=False)
    thre = torch.clamp_max(torch.mean(occs), config.occ_thre)
    binaries = occs > thre
    out = {"occs": occs, "occs_low": occs_low, "binaries": binaries}
    if config.pool > 1:
        out["binaries_pooled"] = _pool_binaries(binaries, config)
    if config.resolution % 4 == 0:
        out["packed_words"] = _pack_supercell_words(binaries, config)
    return out


def occ_update_due(step: int, config: OccGridConfig) -> Tuple[bool, bool]:
    """(due, full) at `step`: due every update_interval steps (nerfacc's
    update_every_n_steps); full during warmup, where only every
    warmup_full_every-th due update is full (umhs_tpu/models/model.py:284-294)."""
    due = step % config.update_interval == 0
    full = step < config.warmup_steps and (
        step % (config.update_interval * max(config.warmup_full_every, 1)) == 0)
    return due, full


def mark_all_occupied(state):
    """Fully occupied grid with the same EMA values."""
    out = dict(state)
    out["binaries"] = torch.ones_like(state["binaries"])
    if "binaries_pooled" in state:
        out["binaries_pooled"] = torch.ones_like(state["binaries_pooled"])
    if "packed_words" in state:
        out["packed_words"] = torch.full_like(state["packed_words"], 0xFFFFFFFF)
    return out
