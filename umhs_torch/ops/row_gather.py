"""P1: the row gather table[idx] of a (T, 2) f32 table (the port of
scripts/probe_pallas_gather.py::_pallas_gather).

`row_gather` launches ``csrc/row_gather.cu`` on a CUDA tensor and runs
`row_gather_plain` on a CPU tensor or when impl="plain" asks for it. It sits
on no path of the system: its entry point is the probe twin
`umhs_torch.probes.gather`, which times it beside `torch.index_select`.
"""

from __future__ import annotations

import ctypes

import torch

from ._native import Kernel

ROW_GATHER = Kernel(
    "row_gather.cu",
    "umhs_row_gather",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
)


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
    n = idx.shape[0]
    out = torch.empty((n, 2), dtype=torch.float32, device=table.device)
    if n == 0:
        return out
    with torch.cuda.device(table.device):
        ROW_GATHER.launch(table.data_ptr(), idx.data_ptr(), out.data_ptr(), n,
                          torch.cuda.current_stream(table.device).cuda_stream)
    return out
