"""K6a and K6b: the compact path's compaction and its lane <-> slot gathers
(port of the staged compact loop of umhs_tpu/models/model.py: the slot map
and `src` at lines 440-454, the densities back through the slot map at 483).

For one stage of the forward (lanes [lo, hi) of every ray, L = hi - lo) with
a budget of Bs rows, `compact_stage` gives the `Compaction`: the slot map
(the exclusive scan of the stage's mask), the lanes kept (slot < Bs), `src`
(the lane each row holds, 0 past the kept total), `live` (rows < total), the
rays' counts and starts in the buffer, and the total. `gather_lanes` brings
the buffer's densities back to the (R, L) lanes through the slot map; its
gradient is the gather the other way, through `src`, since the two invert
each other on kept lanes. The weights' gather through `src` is folded into
K6d (`compositing.compact_accumulate_stages`).

impl="auto" launches ``csrc/compact.cu`` on a CUDA tensor and the plain
version on a CPU tensor; impl="plain" runs the plain version anywhere. The
kernel keeps the total on the device: the plain version's `torch.nonzero`
waits for the device once per stage, the kernel never does. K6a is one
launch a stage, a single-pass scan whose look-back flags live in a
`ScanWorkspace` per device and stream; the host picks its tile
(`compact_tile_rays`: whole rays, or flat tiles of 4,096 lanes that rays
cross, then a second small launch for the counts) and its mask loads
(`mask_vector_bytes`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from ._native import Kernel

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
COMPACT_STAGE = Kernel(
    "compact.cu", "umhs_compact_stage",
    [_P, _I64, _P, _I32, _I32, _I32, _I32, _I32, _P, _I32, ctypes.c_uint32,
     _P, _P, _P, _P, _P, _P, _P, _P, _P],
)
COMPACT_ROUTES = ("whole rays", "flat")  # the route umhs_compact_stage reports
COMPACT_GATHER = Kernel(
    "compact.cu", "umhs_compact_gather",
    [ctypes.c_int, _P, _I64, _I32, _P, _P, _P, _P, _P, _I64, _P],
)


@dataclasses.dataclass(frozen=True)
class Compaction:
    """One stage's compact buffer of Bs rows over (R, L) lanes."""

    slot: torch.Tensor  # (R * L,) int32: the exclusive scan of the stage's mask
    mask: torch.Tensor  # (R, L) bool: the lanes kept (slot < Bs)
    src: torch.Tensor  # (Bs,) int64: the flat lane of each row, 0 past total
    live: torch.Tensor  # (Bs,) float32: 1 for rows below total, else 0
    counts: torch.Tensor  # (R,) int64: kept lanes per ray
    starts: torch.Tensor  # (R,) int64: each ray's first row
    total: Union[int, torch.Tensor]  # kept lanes: an int, or (1,) int32 on the device


TILE_LANES = 4096  # K6a: lanes a tile at most (256 threads x 16 lanes)
LANES_PER_THREAD = 16
EPOCH_LIMIT = 1 << 30  # K6a's epochs run 1 .. EPOCH_LIMIT - 1 (30 bits of a flag word)
MIN_FLAGS = 4096  # K6a: tiles a new workspace holds at least


def compact_tile_rays(L: int) -> int:
    """K6a's rays a tile: the most whole rays within TILE_LANES lanes whose
    lanes are a multiple of LANES_PER_THREAD (so each thread's 16 lanes
    start 64-byte aligned in `slot`); 0 where no such tile exists (L above
    256 and no multiple of L within TILE_LANES a multiple of 16), and K6a
    takes flat tiles of TILE_LANES lanes of the flattened (R, L) instead."""
    if L < 1:
        raise ValueError(f"compact_tile_rays: L {L} below 1")
    step = LANES_PER_THREAD // math.gcd(L, LANES_PER_THREAD)
    return TILE_LANES // L // step * step


def mask_vector_bytes(L: int, stride: int, address: int) -> int:
    """K6a's mask load width: the widest of 16, 8 and 4 bytes that divides
    the lanes a ray, the row stride and the slice's address, else 1."""
    return next((v for v in (16, 8, 4) if L % v == 0 and stride % v == 0 and address % v == 0),
                1)


class ScanWorkspace:
    """K6a's look-back flags on one device and stream: a ticket (int64 0)
    and one flag a tile. Allocated zeroed once and grown when a stage has
    more tiles; never cleared per call: each call takes the next epoch, and
    a flag counts only with its call's epoch. When the epochs run out
    (EPOCH_LIMIT - 1 calls) the buffer is cleared once and they restart."""

    def __init__(self):
        self.buffer: Optional[torch.Tensor] = None
        self.epoch = 0

    def take(self, n_tiles: int, device) -> Tuple[torch.Tensor, int]:
        """(the buffer, this call's epoch) for a launch of n_tiles tiles."""
        if self.buffer is None or self.buffer.numel() - 1 < n_tiles:
            self.buffer = torch.zeros(1 + max(n_tiles, MIN_FLAGS), dtype=torch.int64,
                                      device=device)
            self.epoch = 0
        self.epoch += 1
        if self.epoch >= EPOCH_LIMIT:
            self.buffer.zero_()
            self.epoch = 1
        return self.buffer, self.epoch


_WORKSPACES: Dict[Tuple[int, int], ScanWorkspace] = {}
# two threads on one stream (a server's renders) must never take one epoch
_WORKSPACES_LOCK = threading.Lock()


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def compact_stage_plain(mask: torch.Tensor, live_rays: Optional[torch.Tensor],
                        budget: int) -> Compaction:
    """Plain version of K6a: mask (R, L) bool (the stage's lanes), live_rays
    (R,) bool or None, budget Bs rows."""
    R, L = mask.shape
    m = mask
    if live_rays is not None:
        m = m & live_rays[:, None]
    flat_mask = m.reshape(-1)
    fm = flat_mask.int()
    slot = torch.cumsum(fm, dim=0, dtype=torch.int32) - fm
    # drop overflow so no slot past the buffer is ever read
    flat_mask = flat_mask & (slot < budget)
    m = flat_mask.reshape(R, L)
    kept = torch.nonzero(flat_mask).squeeze(1)  # ascending == slot order
    total = kept.shape[0]
    src = torch.zeros(budget, dtype=torch.int64, device=mask.device)
    src[:total] = kept
    live = (torch.arange(budget, device=mask.device) < total).float()
    counts = m.sum(dim=-1)
    starts = torch.cumsum(counts, dim=0) - counts
    return Compaction(slot, m, src, live, counts, starts, total)


def compact_stage_cuda(mask: torch.Tensor, live_rays: Optional[torch.Tensor],
                       budget: int) -> Compaction:
    """K6a on the card: as compact_stage_plain, with the total on the
    device. mask may be a column slice of a wider (R, S) bool mask."""
    if mask.dtype != torch.bool or mask.dim() != 2 or mask.stride(1) != 1:
        raise ValueError("compact_stage_cuda: mask must be an (R, L) bool tensor with unit "
                         "column stride")
    R, L = mask.shape
    if L < 1 or R * L >= 2**31 or not 0 < budget < 2**31:
        raise ValueError(f"compact_stage_cuda: shape ({R}, {L}) or budget {budget} is beyond the "
                         "kernel's int32 lane and row indices, or empty (1 <= L, R * L < 2^31, "
                         "1 <= budget < 2^31)")
    if live_rays is not None and (live_rays.dtype != torch.bool or live_rays.shape != (R,)
                                  or live_rays.device != mask.device
                                  or not live_rays.is_contiguous()):
        raise ValueError("compact_stage_cuda: live_rays must be a contiguous (R,) bool tensor "
                         "on the mask's device")
    if mask.device.type != "cuda":
        raise ValueError(f"compact_stage_cuda: needs a CUDA tensor, not {mask.device}")
    dev = mask.device
    tile_rays = compact_tile_rays(L)
    n_tiles = -(-R // tile_rays) if tile_rays else -(-R * L // TILE_LANES)
    stream = _stream(mask)
    with _WORKSPACES_LOCK:
        ws = _WORKSPACES.setdefault((dev.index, stream), ScanWorkspace())
        flags, epoch = ws.take(n_tiles, dev)
    slot = torch.empty(R * L, dtype=torch.int32, device=dev)
    kept = torch.empty((R, L), dtype=torch.bool, device=dev)
    src = torch.empty(budget, dtype=torch.int64, device=dev)
    live = torch.empty(budget, dtype=torch.float32, device=dev)
    counts = torch.empty(R, dtype=torch.int64, device=dev)
    starts = torch.empty(R, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        COMPACT_STAGE.launch(
            mask.data_ptr(), mask.stride(0),
            live_rays.data_ptr() if live_rays is not None else None, R, L, budget, tile_rays,
            mask_vector_bytes(L, mask.stride(0), mask.data_ptr()), flags.data_ptr(),
            flags.numel() - 1, epoch, slot.data_ptr(), kept.data_ptr(), src.data_ptr(),
            live.data_ptr(), counts.data_ptr(), starts.data_ptr(), total.data_ptr(), stream,
            routes=COMPACT_ROUTES)
    return Compaction(slot, kept, src, live, counts, starts, total)


def compact_stage(mask: torch.Tensor, live_rays: Optional[torch.Tensor], budget: int,
                  impl: str = "auto") -> Compaction:
    """The stage's Compaction: K6a on a CUDA tensor with impl="auto", else
    the plain version."""
    _check_impl(impl)
    if impl == "plain" or mask.device.type == "cpu":
        return compact_stage_plain(mask, live_rays, budget)
    return compact_stage_cuda(mask, live_rays, budget)


def device_total(c: Compaction) -> torch.Tensor:
    """The total of a compaction K6a made: a (1,) int32 tensor on the card."""
    if not isinstance(c.total, torch.Tensor):
        raise ValueError("the kernels take a compaction from compact_stage_cuda")
    return c.total


def gather_lanes_plain(rows: torch.Tensor, c: Compaction) -> torch.Tensor:
    """Plain version of K6b: (Bs,) rows -> (R, L) lanes, rows[slot] on kept
    lanes and 0 elsewhere."""
    R, L = c.mask.shape
    back = rows[torch.clamp(c.slot.reshape(R, L).long(), 0, rows.shape[0] - 1)]
    return torch.where(c.mask, back, torch.zeros_like(back))


def _check_gather(name: str, x: torch.Tensor, c: Compaction) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: needs float32, not {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, not {x.device}")
    if c.mask.device != x.device:
        raise ValueError(f"{name}: the compaction lies on {c.mask.device}, not {x.device}")


def lanes_from_rows_cuda(rows: torch.Tensor, c: Compaction) -> torch.Tensor:
    """K6b, rows -> lanes: (Bs,) f32 -> (R, L) f32 through the slot map."""
    R, L = c.mask.shape
    if rows.shape != c.src.shape or not rows.is_contiguous():
        raise ValueError(f"lanes_from_rows_cuda: rows must be contiguous {tuple(c.src.shape)}, "
                         f"not {tuple(rows.shape)}")
    _check_gather("lanes_from_rows_cuda", rows, c)
    out = torch.empty((R, L), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        COMPACT_GATHER.launch(0, rows.data_ptr(), 0, L, c.slot.data_ptr(), c.mask.data_ptr(),
                              None, None, out.data_ptr(), R * L, _stream(rows))
    return out


def rows_from_lanes_cuda(lanes: torch.Tensor, c: Compaction) -> torch.Tensor:
    """K6b, lanes -> rows: (R, L) f32 (any row stride) -> (Bs,) f32 through
    `src`, 0 on rows past the total."""
    if lanes.shape != c.mask.shape or lanes.stride(1) != 1:
        raise ValueError(f"rows_from_lanes_cuda: lanes must be {tuple(c.mask.shape)} with unit "
                         f"column stride, not {tuple(lanes.shape)}")
    _check_gather("rows_from_lanes_cuda", lanes, c)
    total = device_total(c)
    n = c.src.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=lanes.device)
    with torch.cuda.device(lanes.device):
        COMPACT_GATHER.launch(1, lanes.data_ptr(), lanes.stride(0), lanes.shape[1], None, None,
                              c.src.data_ptr(), total.data_ptr(), out.data_ptr(), n,
                              _stream(lanes))
    return out


class _GatherLanes(torch.autograd.Function):
    """K6b rows -> lanes forward, lanes -> rows backward."""

    @staticmethod
    def forward(ctx, rows, c):
        ctx.c = c
        return lanes_from_rows_cuda(rows, c)

    @staticmethod
    def backward(ctx, g):
        return rows_from_lanes_cuda(g.float(), ctx.c), None


def gather_lanes(rows: torch.Tensor, c: Compaction, impl: str = "auto") -> torch.Tensor:
    """(Bs,) rows -> (R, L) lanes through the slot map, 0 on lanes not kept:
    K6b on a CUDA tensor with impl="auto" (its gradient K6b the other way),
    else the plain version."""
    _check_impl(impl)
    if impl == "plain" or rows.device.type == "cpu":
        return gather_lanes_plain(rows, c)
    return _GatherLanes.apply(rows.contiguous(), c)
