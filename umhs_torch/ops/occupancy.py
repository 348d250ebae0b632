"""Multi-level binary occupancy grid (port of umhs_tpu/ops/occupancy.py).

The grid is a dict of flat tensors: the EMA densities ``occs`` and their
lower envelope ``occs_low`` (levels * res^3,), the bitfield ``binaries``,
the max-pooled bitfield ``binaries_pooled`` when pool > 1, and when res % 4
== 0 the packed supercell words ``packed_words``: each 4^3-cell supercell's
occupancy as one 64-bit word, stored as [lo, hi] uint32 halves in an int64
tensor (torch's uint32 support is thin). Level i covers the level-0 box
scaled by 2^i; a position is looked up in the finest level containing it.

This slice has the full update (every cell of every level, with the jitter
passed in); the sampled partial update comes with training.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

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


def update_occ_state(
    state,
    config: OccGridConfig,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    render_step_size: float,
    jitter: torch.Tensor,
):
    """One full EMA update: every cell of every level is probed at the
    jittered point `jitter` (levels * res^3, 3) in [0, 1)^3 inside it.

    occs <- max(occs * decay, density * step); the lower envelope drops to a
    lower probe at once and rises at most x2 per update (seeded at occ_thre);
    binaries = occs > min(mean(occs), occ_thre), then pooled and packed."""
    res3 = config.cells_per_level
    L = config.levels
    dev = jitter.device
    cell_flat = torch.arange(res3, device=dev).repeat(L)
    level = torch.arange(L, device=dev).repeat_interleave(res3)
    positions = _level_world_positions(config, level, cell_flat, jitter)
    occ = _eval_occ(density_fn, positions) * render_step_size
    # a NaN would persist through the EMA max and silently empty the grid
    occ = torch.nan_to_num(occ)

    occs = torch.maximum(state["occs"] * config.ema_decay, occ)
    rise = torch.clamp_min(state["occs_low"] * 2.0, config.occ_thre)
    occs_low = torch.minimum(occ, rise)
    thre = torch.clamp_max(torch.mean(occs), config.occ_thre)
    binaries = occs > thre
    out = {"occs": occs, "occs_low": occs_low, "binaries": binaries}
    if config.pool > 1:
        out["binaries_pooled"] = _pool_binaries(binaries, config)
    if config.resolution % 4 == 0:
        out["packed_words"] = _pack_supercell_words(binaries, config)
    return out


def mark_all_occupied(state):
    """Fully occupied grid with the same EMA values."""
    out = dict(state)
    out["binaries"] = torch.ones_like(state["binaries"])
    if "binaries_pooled" in state:
        out["binaries_pooled"] = torch.ones_like(state["binaries_pooled"])
    if "packed_words" in state:
        out["packed_words"] = torch.full_like(state["packed_words"], 0xFFFFFFFF)
    return out
