"""P1: the row gather table[idx] of a (T, 2) f32 table (the port of
scripts/probe_pallas_gather.py::_pallas_gather).

`row_gather` launches ``csrc/row_gather.cu`` on a CUDA tensor and runs
`row_gather_plain` on a CPU tensor or when impl="plain" asks for it. It sits
on no path of the system: its entry point is the probe twin
`umhs_torch.probes.gather`, which times it beside `torch.index_select`.

The kernel walks the table in slices (`row_gather_slices`): a block reads
the indices of its wave of THREADS * ROWS rows once, gathers in each slice
the rows whose index falls in it, and writes the wave out; `row_gather_grid`
gives its grid. The launcher passes both to the kernel, so that the CPU
tests can hold the kernel's partition of the rows to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ._native import Kernel

ROW_GATHER = Kernel(
    "row_gather.cu",
    "umhs_row_gather",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
     ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p],
)
# csrc/row_gather.cu's block (kThreads, kRows there): THREADS threads of ROWS
# rows each make a wave
THREADS, ROWS = 128, 14
WAVE = THREADS * ROWS
# table bytes per slice, and at most this many slices: on an H100 (700 W)
# six slices ran fastest on the 96 MB table, with one, three and twelve
# slower; on the 48.8 MB table three and six tied (PERF.md, P1)
SLICE_BYTES = 8 << 20
MAX_SLICES = 6
_BLOCKS_PER_SM: Dict[int, int] = {}  # device index -> the kernel's resident blocks per SM


def row_gather_slices(table_rows: int) -> int:
    """How many slices the kernel walks a (table_rows, 2) f32 table in."""
    return min(MAX_SLICES, max(1, -(-table_rows * 8 // SLICE_BYTES)))


def row_gather_grid(n: int, sms: int, blocks_per_sm: int) -> int:
    """The kernel's block count for n rows on a card of `sms` SMs with
    `blocks_per_sm` of its blocks resident on each: one block per wave, at
    most the resident blocks, each striding over the waves."""
    return min(-(-n // WAVE), sms * blocks_per_sm)


def _blocks_per_sm(device: torch.device) -> int:
    """The kernel's resident blocks per SM on `device` (its occupancy)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _BLOCKS_PER_SM:
        fn = ROW_GATHER.library().umhs_row_gather_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
        blocks = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"umhs_row_gather_blocks_per_sm failed: cudaError {err}, "
                               f"{blocks.value} blocks")
        _BLOCKS_PER_SM[index] = blocks.value
    return _BLOCKS_PER_SM[index]


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: the rows table[idx] -> (N, 2)."""
    return table[idx.long()]


def row_gather(table: torch.Tensor, idx: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """table (T, 2) float32, idx (N,) int32 -> (N, 2) float32, for any N.

    Every index must lie in [0, T): the kernel reads table[idx] unchecked, as
    the Pallas kernel's DMA did. impl="auto" launches the kernel on a CUDA
    tensor and the plain version on a CPU tensor; impl="plain" runs the plain
    version anywhere."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl == "plain" or table.device.type == "cpu":
        return row_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {table.device}")
    if (table.dtype != torch.float32 or table.dim() != 2 or table.shape[1] != 2
            or not table.is_contiguous() or table.data_ptr() % 8 != 0):
        raise ValueError("row_gather: table must be a contiguous, 8-byte aligned (T, 2) "
                         "float32 tensor")
    if (idx.dtype != torch.int32 or idx.dim() != 1 or idx.device != table.device
            or not idx.is_contiguous()):
        raise ValueError("row_gather: idx must be a contiguous (N,) int32 tensor on the "
                         "table's device")
    t = table.shape[0]
    if not 0 < t < 2**31:
        raise ValueError(f"row_gather: the table must have 1 to 2^31 - 1 rows, not {t}")
    slices = row_gather_slices(t)
    n = idx.shape[0]
    out = torch.empty((n, 2), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    blocks = row_gather_grid(n, sms, _blocks_per_sm(table.device))
    with torch.cuda.device(table.device):
        ROW_GATHER.launch(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, t, -(-t // slices),
                          blocks, torch.cuda.current_stream(table.device).cuda_stream)
    return out
