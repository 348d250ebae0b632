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

K7, the update on the card (``csrc/occupancy.cu``, port of the XLA code of
umhs_tpu/ops/occupancy.py:347 `update_occ_state`): K7a `umhs_occ_update`
chooses a partial update's cells from its draws and places the probes
before the density evaluation, and folds the densities into the EMA after
it; K7b `umhs_occ_pack` thresholds, pools and packs in one pass.
impl="auto" launches them on a CUDA tensor, the plain version runs on a CPU
tensor or with impl="plain"; both give the same bits. On the card a partial
update writes the state's `occs` and `occs_low` in place. The density
evaluation (K3 and K1) and the mean of `occs` stay PyTorch calls. Nothing
is read back.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ._native import Kernel
from .compact import _check_impl, _stream


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


def _threshold_pack_plain(occs: torch.Tensor, mean: torch.Tensor, config: OccGridConfig):
    """Plain version of K7b: binaries = occs > min(mean, occ_thre), then the
    pooled bitfield (pool > 1) and the packed words (res % 4 == 0)."""
    thre = torch.clamp_max(mean, config.occ_thre)
    binaries = occs > thre
    out = {"binaries": binaries}
    if config.pool > 1:
        out["binaries_pooled"] = _pool_binaries(binaries, config)
    if config.resolution % 4 == 0:
        out["packed_words"] = _pack_supercell_words(binaries, config)
    return out


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
    impl: str = "auto",
    *,
    draws: Optional[List[Dict[str, torch.Tensor]]] = None,
):
    """One EMA update. Full when `cells` and `draws` are None: every cell of
    every level is probed at the jittered point `jitter` (levels * res^3, 3)
    in [0, 1)^3 inside it. Partial otherwise, at jitter (M, 3): the (level,
    cell) pairs `cells` (M,), or the cells `partial_cells` chooses from the
    draws `draws` (draw_partial_cells' levels).

    occs <- max(occs * decay, density * step); the lower envelope drops to a
    lower probe at once and rises at most x2 per update (seeded at occ_thre);
    binaries = occs > min(mean(occs), occ_thre), then pooled and packed.

    Cells are drawn with replacement, so a partial update can probe one cell
    twice. The rule here, deterministic on every device: the largest probe
    wins in `occs` and the smallest in `occs_low` (the JAX package's
    scatter-set leaves the winner unspecified; the two agree on cells probed
    once).

    impl="auto": K7 on a CUDA tensor, the plain version on a CPU tensor;
    impl="plain": the plain version anywhere. On the card a partial update
    takes the state's grids over: it writes `occs` and `occs_low` in place
    and returns them, so the caller must not use the old state afterwards
    (pass clones to update one state twice). The plain version returns new
    tensors."""
    _check_impl(impl)
    if cells is not None and draws is not None:
        raise ValueError("update_occ_state: give cells or draws, not both")
    if impl == "plain" or jitter.device.type == "cpu":
        return update_occ_state_plain(state, config, density_fn, render_step_size, jitter, cells,
                                      draws=draws)
    return update_occ_state_cuda(state, config, density_fn, render_step_size, jitter, cells,
                                 draws=draws)


def update_occ_state_plain(
    state,
    config: OccGridConfig,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    render_step_size: float,
    jitter: torch.Tensor,
    cells: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    draws: Optional[List[Dict[str, torch.Tensor]]] = None,
):
    """Plain version of update_occ_state (K7a and K7b): the cells from
    partial_cells, the grids new tensors."""
    if draws is not None:
        cells = partial_cells(state, config, draws)
    level, cell_flat = _probe_cells_plain(config, jitter.device, cells)
    positions = _level_world_positions(config, level, cell_flat, jitter)
    occ = _eval_occ(density_fn, positions) * render_step_size
    occs, occs_low = _fold_plain(state, config, occ, level, cell_flat, full=cells is None)
    out = {"occs": occs, "occs_low": occs_low}
    out.update(_threshold_pack_plain(occs, torch.mean(occs), config))
    return out


def _probe_cells_plain(config: OccGridConfig, dev, cells):
    """(level, cell) of every probe: every cell of every level, or `cells`."""
    if cells is None:
        res3, L = config.cells_per_level, config.levels
        return (torch.arange(L, device=dev).repeat_interleave(res3),
                torch.arange(res3, device=dev).repeat(L))
    return tuple(c.long() for c in cells)


def _fold_plain(state, config: OccGridConfig, occ, level, cell_flat, full: bool):
    """Plain version of K7a's fold: the probes' density * step `occ` into
    (occs, occs_low)."""
    # a NaN would persist through the EMA max and silently empty the grid
    occ = torch.nan_to_num(occ)
    if full:
        occs = torch.maximum(state["occs"] * config.ema_decay, occ)
        rise = torch.clamp_min(state["occs_low"] * 2.0, config.occ_thre)
        return occs, torch.minimum(occ, rise)
    flat_idx = level * config.cells_per_level + cell_flat
    new = torch.maximum(state["occs"][flat_idx] * config.ema_decay, occ)
    rise = torch.clamp_min(state["occs_low"][flat_idx] * 2.0, config.occ_thre)
    new_low = torch.minimum(occ, rise)
    occs = state["occs"].scatter_reduce(0, flat_idx, new, "amax", include_self=False)
    occs_low = state["occs_low"].scatter_reduce(0, flat_idx, new_low, "amin",
                                                include_self=False)
    return occs, occs_low


class OccParams(ctypes.Structure):
    """The grid's constants, passed to K5 and K7 by value (csrc/occupancy.cuh
    `OccParams`): each float as PyTorch's CUDA kernels round it."""

    _fields_ = [
        ("res", ctypes.c_int32), ("levels", ctypes.c_int32), ("pool", ctypes.c_int32),
        ("center", ctypes.c_float * 3), ("half", ctypes.c_float * 3),
        ("inv_res", ctypes.c_float), ("max_scale", ctypes.c_float), ("min_maxc", ctypes.c_float),
        ("decay", ctypes.c_float), ("occ_thre", ctypes.c_float), ("step", ctypes.c_float),
    ]


def occ_params(config: OccGridConfig, render_step_size: float = 0.0) -> OccParams:
    """OccParams of `config`: a Python number that the plain version divides
    by is taken as its f32 reciprocal, since PyTorch's CUDA division by a
    Python number multiplies by that."""
    res = config.resolution
    return OccParams(
        res=res, levels=config.levels, pool=config.pool,
        center=(ctypes.c_float * 3)(*config.center.tolist()),
        half=(ctypes.c_float * 3)(*config.half_extent.tolist()),
        inv_res=float(np.float32(1.0) / np.float32(res)), max_scale=config.max_scale,
        min_maxc=1e-12, decay=config.ema_decay, occ_thre=config.occ_thre,
        step=render_step_size,
    )


class DrawLevel(ctypes.Structure):
    """One level's row of a partial update's draws as K7a reads them from a
    device table (csrc/occupancy.cuh `DrawLevel`): its first probe, its
    uniform cells' count, where its uniform and its occupied draws start in
    the levels' concatenated draws; levels + 1 rows, the last holding the
    probes' total in `start`."""

    _fields_ = [
        ("start", ctypes.c_int64), ("uniform_n", ctypes.c_int64),
        ("uniform_at", ctypes.c_int64), ("occupied_at", ctypes.c_int64),
        ("inv_occ_n", ctypes.c_float), ("pad", ctypes.c_int32),
    ]


_DRAW_TABLES = {}  # ((uniform, occupied) draws a level, device) -> K7a's table of levels


_P, _I64 = ctypes.c_void_p, ctypes.c_int64
OCC_UPDATE = Kernel("occupancy.cu", "umhs_occ_update",
                    [ctypes.c_int, _P, _P, _P, _P, _P, _I64] + [_P] * 13 + [_P])
OCC_PACK = Kernel("occupancy.cu", "umhs_occ_pack", [_P, _P, _P, _P, _P, _P, _P])


def check_grid_limits(config: OccGridConfig, name: str) -> None:
    """Refuse, before any launch, a grid whose cells an int32 cannot index."""
    if config.levels * config.cells_per_level >= 2**31 or config.levels < 1:
        raise ValueError(f"{name}: a grid of {config.levels} x {config.resolution}^3 cells is "
                         "beyond the kernel's int32 cell index")


def update_occ_state_cuda(
    state,
    config: OccGridConfig,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    render_step_size: float,
    jitter: torch.Tensor,
    cells: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    *,
    draws: Optional[List[Dict[str, torch.Tensor]]] = None,
):
    """update_occ_state on the card: K7a chooses the cells and places the
    probes (occ_probe_cuda), the density is evaluated, K7a folds it in
    (occ_fold_cuda), then K7b thresholds, pools and packs against the
    device's mean. A partial update writes the state's grids in place."""
    probes = occ_probe_cuda(state, config, jitter, cells, draws=draws)
    sigma = _eval_occ(density_fn, probes.positions)
    out = occ_fold_cuda(probes, sigma, render_step_size)
    out.update(threshold_pack_cuda(out["occs"], torch.mean(out["occs"]), config))
    return out


@dataclasses.dataclass
class Probes:
    """K7a's probes between its two launches: the world positions (n, 3),
    the grids being written (new ones for a full update, the state's for a
    partial one) and, partial, each probe's flat cell index (n,) int32."""

    state: dict
    config: OccGridConfig
    positions: torch.Tensor
    occs: torch.Tensor
    occs_low: torch.Tensor
    flat: Optional[torch.Tensor]


def _draws_table(draws, config: OccGridConfig, dev):
    """The draws as K7a takes them: every level's uniform cells (int64),
    offsets u (float32) and fallback cells (int64) concatenated on `dev`,
    level after level, and the device table of levels + 1 `DrawLevel` rows
    over them, built once per shape of the draws (no copy from the host on
    later calls); returns (table, (uniform, u, fallback), probes)."""
    if len(draws) != config.levels:
        raise ValueError(f"update_occ_state_cuda: {len(draws)} levels of draws for a grid of "
                         f"{config.levels}")
    for d in draws:
        if d["uniform"].dim() != 1 or d["u"].dim() != 1 or d["fallback"].shape != d["u"].shape:
            raise ValueError("update_occ_state_cuda: each level's draws are (m_uni,) uniform "
                             "cells, (m_occ,) offsets u and (m_occ,) fallback cells")
    shapes = tuple((d["uniform"].shape[0], d["u"].shape[0]) for d in draws)
    key = (shapes, dev)
    if key not in _DRAW_TABLES:
        D, n, uni_at, occ_at = (DrawLevel * (config.levels + 1))(), 0, 0, 0
        for row, (m_uni, m_occ) in zip(D, shapes):
            row.start, row.uniform_n, row.uniform_at, row.occupied_at = n, m_uni, uni_at, occ_at
            # (arange + u) / m_occ divides by a Python number: its f32 reciprocal
            row.inv_occ_n = float(np.float32(1.0) / np.float32(m_occ)) if m_occ else 0.0
            n, uni_at, occ_at = n + m_uni + m_occ, uni_at + m_uni, occ_at + m_occ
        D[config.levels].start = n
        _DRAW_TABLES[key] = (torch.frombuffer(bytearray(D), dtype=torch.uint8).to(dev), n)
    table, n = _DRAW_TABLES[key]
    cat = [torch.cat([d[k].to(device=dev, dtype=t) for d in draws]).contiguous()
           for k, t in (("uniform", torch.int64), ("u", torch.float32), ("fallback", torch.int64))]
    return table, tuple(cat), n


def occ_probe_cuda(state, config: OccGridConfig, jitter: torch.Tensor,
                   cells: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, *,
                   draws: Optional[List[Dict[str, torch.Tensor]]] = None) -> Probes:
    """K7a, mode 0: the probes' world positions; for a partial update also
    the cells (given, or chosen from `draws` against state["binaries"]) and,
    once at each probed cell, the values its probes share (occs * decay and
    the envelope's rise), written into the state's grids in place."""
    check_grid_limits(config, "update_occ_state_cuda")
    dev = jitter.device
    if dev.type != "cuda":
        raise ValueError(f"update_occ_state_cuda: needs a CUDA tensor, not {dev}")
    ncells = config.levels * config.cells_per_level
    D, keep, level, cell, binaries = None, (None, None, None), None, None, None
    if draws is not None:
        D, keep, n = _draws_table(draws, config, dev)
        binaries = state["binaries"]
        if (binaries.dtype != torch.bool or binaries.device != dev or binaries.numel() != ncells
                or not binaries.is_contiguous() or binaries.data_ptr() % 4):
            raise ValueError(f"update_occ_state_cuda: state['binaries'] must be a contiguous, "
                             f"4-byte aligned ({ncells},) bool grid on {dev}")
    elif cells is not None:
        level, cell = (c.to(device=dev, dtype=torch.int64).contiguous() for c in cells)
        n = level.shape[0]
        if level.shape != (n,) or cell.shape != (n,):
            raise ValueError("update_occ_state_cuda: cells must be two (M,) tensors")
    else:
        n = ncells
    if jitter.dtype != torch.float32 or tuple(jitter.shape) != (n, 3) or n == 0:
        raise ValueError(f"update_occ_state_cuda: jitter must be ({n}, 3) float32, not "
                         f"{tuple(jitter.shape)} {jitter.dtype}")
    for key in ("occs", "occs_low"):
        t = state[key]
        if (t.dtype != torch.float32 or t.device != dev or not t.is_contiguous()
                or t.numel() != ncells):
            raise ValueError(f"update_occ_state_cuda: state[{key!r}] must be a contiguous "
                             f"float32 grid on {dev}")
    partial = cells is not None or draws is not None
    if partial:  # the state's grids, written in place
        occs, occs_low = state["occs"], state["occs_low"]
        flat = torch.empty(n, dtype=torch.int32, device=dev)
        seen = torch.empty((ncells + 31) // 32, dtype=torch.int32, device=dev)
    else:
        occs, occs_low = torch.empty_like(state["occs"]), torch.empty_like(state["occs_low"])
        flat = seen = None
    res, L = config.resolution, config.levels
    counts = (torch.empty(L * res * res + L * res, dtype=torch.int32, device=dev)
              if draws is not None else None)
    probes = Probes(state, config, torch.empty((n, 3), dtype=torch.float32, device=dev), occs,
                    occs_low, flat)
    OCC_UPDATE.check_struct("umhs_occ_params_size", OccParams)
    OCC_UPDATE.check_struct("umhs_occ_draws_size", DrawLevel)
    with torch.cuda.device(dev):
        OCC_UPDATE.launch(0, ctypes.byref(occ_params(config)), _ptr(D), *map(_ptr, keep), n,
                          _ptr(level), _ptr(cell),
                          _ptr(binaries), jitter.contiguous().data_ptr(), occs.data_ptr(),
                          occs_low.data_ptr(), None, probes.positions.data_ptr(), None, None,
                          _ptr(flat), _ptr(seen), _ptr(counts), _stream(jitter))
    del keep  # the stream orders any reuse of their memory after the launch
    return probes


def occ_fold_cuda(probes: Probes, sigma: torch.Tensor, render_step_size: float):
    """K7a, mode 1: the densities `sigma` (n,) at the probes folded into the
    grids: {"occs", "occs_low"}, those `probes` holds."""
    n = probes.positions.shape[0]
    if sigma.dtype != torch.float32 or sigma.shape != (n,) or sigma.device != \
            probes.positions.device:
        raise ValueError(f"update_occ_state_cuda: the density must be ({n},) float32 on the "
                         f"card, not {tuple(sigma.shape)} {sigma.dtype}")
    state = probes.state
    with torch.cuda.device(sigma.device):
        OCC_UPDATE.launch(1, ctypes.byref(occ_params(probes.config, render_step_size)), None,
                          None, None, None, n,
                          None, None, None, None, state["occs"].data_ptr(),
                          state["occs_low"].data_ptr(), sigma.contiguous().data_ptr(), None,
                          probes.occs.data_ptr(), probes.occs_low.data_ptr(), _ptr(probes.flat),
                          None, None, _stream(sigma))
    return {"occs": probes.occs, "occs_low": probes.occs_low}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def threshold_pack_cuda(occs: torch.Tensor, mean: torch.Tensor, config: OccGridConfig):
    """K7b: as _threshold_pack_plain, in one pass (one thread a 4^3
    supercell where res % 4 == 0, its rows read as float4, so occs must be
    16-byte aligned there; else a thread a cell, then a thread a pooled cell
    for a pool other than 4), with the mean read on the device."""
    check_grid_limits(config, "threshold_pack_cuda")
    n = config.levels * config.cells_per_level
    if occs.dtype != torch.float32 or occs.shape != (n,) or not occs.is_contiguous() \
            or occs.device.type != "cuda":
        raise ValueError(f"threshold_pack_cuda: occs must be a contiguous ({n},) float32 "
                         "tensor on the card")
    r, L, p = config.resolution, config.levels, config.pool
    if r % 4 == 0 and occs.data_ptr() % 16:
        raise ValueError("threshold_pack_cuda: occs must be 16-byte aligned (its rows are "
                         "read as float4)")
    if mean.dtype != torch.float32 or mean.numel() != 1 or mean.device != occs.device:
        raise ValueError("threshold_pack_cuda: mean must be one float32 on occs' device")
    dev = occs.device
    out = {"binaries": torch.empty(n, dtype=torch.bool, device=dev)}
    if p > 1:
        out["binaries_pooled"] = torch.empty(L * (r // p) ** 3, dtype=torch.bool, device=dev)
    if r % 4 == 0:
        out["packed_words"] = torch.empty(L * (r // 4) ** 3 * 2, dtype=torch.int64, device=dev)
    OCC_PACK.check_struct("umhs_occ_params_size", OccParams)
    with torch.cuda.device(dev):
        OCC_PACK.launch(ctypes.byref(occ_params(config)), occs.data_ptr(),
                        mean.contiguous().data_ptr(), out["binaries"].data_ptr(),
                        out["packed_words"].data_ptr() if "packed_words" in out else None,
                        out["binaries_pooled"].data_ptr() if "binaries_pooled" in out else None,
                        _stream(occs))
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
