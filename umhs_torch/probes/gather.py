"""Row-gather probe: the hand-written row gather P1 against torch.index_select
(the twin of scripts/probe_pallas_gather.py, whose arms were XLA's gather and
a Pallas DMA gather).

    python -m umhs_torch.probes.gather [--check] [--rows N] [--device cuda|cpu]

Arms, at the probe's shapes and on the flagship's hash table:
  library   torch.index_select(table, 0, idx), PyTorch's gather (the
            probe's XLA arm)
  kernel    P1, umhs_torch/csrc/row_gather.cu, one thread and one float2
            load per row

Tables: the probe's 12,000,000 x 2 f32 (96 MB, more than the H100's 50 MB
L2; the JAX probe's comment says ~48 MB) and the flagship's L16xF2 2^19 table
of 6,098,108 x 2 f32 (48.8 MB, which nearly fits). Rows: 16,318,464 random
indices (254,976 compact samples x 64 tetrahedral lanes), or --rows N. Each
line gives rows, the median of CUDA-event-timed calls, ns per row and the
bytes bound. Measuring needs the card.

--check compares the kernel with the plain version bit for bit on the card;
with --device cpu it compares the plain version with a numpy take on the
CPU. The device is cuda unless --device cpu is given, and without a card the
probe raises rather than fall back.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.row_gather import row_gather, row_gather_plain

F = 2
PROBE_TABLE_ROWS = 12_000_000  # probe_pallas_gather.py:121
FLAGSHIP_TABLE_ROWS = 6_098_108  # sum of the L16xF2 2^19 level sizes
PROBE_ROWS = 254_976 * 64  # probe_pallas_gather.py:125 (a multiple of 2048)
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet


def make_case(table_rows: int, rows: int, device, seed: int = 0):
    """A (table_rows, 2) f32 table of normal values and `rows` uniform int32
    indices into it, drawn on `device` from a generator seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn((table_rows, F), generator=gen, device=device)
    idx = torch.randint(0, table_rows, (rows,), generator=gen, device=device, dtype=torch.int32)
    return table, idx


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bounds_ms(idx: torch.Tensor) -> Dict[str, float]:
    """The gather's bytes bounds at 3.35 TB/s: `bound_ms` reads each index and
    each 32-byte table sector the indices touch once and writes each output
    row once; `sector_bound_ms` charges one sector per row."""
    n = idx.shape[0]
    sectors = int(torch.unique(idx.long() * (4 * F) // 32).numel())
    return {
        "bound_ms": (n * 4 + n * 4 * F + sectors * 32) / H100_BYTES_PER_S * 1e3,
        "sector_bound_ms": n * (4 + 4 * F + 32) / H100_BYTES_PER_S * 1e3,
        "unique_sectors": sectors,
    }


def measure(table_rows: int, rows: int, device, seed: int = 0) -> Dict[str, object]:
    """Both arms on one table: their median ms and ns per row, and the bounds."""
    table, idx = make_case(table_rows, rows, device, seed)
    result: Dict[str, object] = {"table_rows": table_rows, "rows": rows, **bounds_ms(idx)}
    for arm, fn in (("library", lambda: torch.index_select(table, 0, idx)),
                    ("kernel", lambda: row_gather(table, idx))):
        ms = median_ms(fn)
        result[f"{arm}_ms"] = ms
        result[f"{arm}_ns_per_row"] = ms * 1e6 / rows
    return result


def check(device, rows: int = PROBE_ROWS) -> List[str]:
    """Bit-for-bit checks, with the table's last row first among the indices
    and its first row last; raises AssertionError on a mismatch. On the
    card: the kernel against the plain version at `rows` rows on the probe's
    and the flagship's table, and at N = 2049 and 1. On the CPU: the plain
    version against numpy's take."""
    lines = []
    if device.type == "cuda":
        cases = [(PROBE_TABLE_ROWS, rows), (FLAGSHIP_TABLE_ROWS, rows),
                 (PROBE_TABLE_ROWS, 2049), (PROBE_TABLE_ROWS, 1)]
    else:
        cases = [(4096, 2 * 2048), (4096, 2049), (4096, 1)]
    for table_rows, n in cases:
        table, idx = make_case(table_rows, n, device, seed=n)
        idx[0] = table_rows - 1
        if n > 1:
            idx[-1] = 0
        if device.type == "cuda":
            got, want, arms = row_gather(table, idx), row_gather_plain(table, idx), "kernel/plain"
        else:
            got = row_gather(table, idx)
            want = torch.from_numpy(np.take(table.numpy(), idx.numpy(), axis=0))
            arms = "plain/numpy"
        assert got.shape == (n, F) and got.dtype == torch.float32
        assert torch.equal(got, want), f"{arms} differ at T={table_rows} N={n}"
        lines.append(f"check {arms} T={table_rows:,} N={n:,}: bit for bit")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, object]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="bit-for-bit correctness only")
    ap.add_argument("--rows", type=int, default=0, help="override the gathered row count")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to run (cpu: --check of the plain version only)")
    args = ap.parse_args(argv)
    rows = args.rows or PROBE_ROWS
    if args.device == "cpu" and not args.check:
        raise SystemExit("gather probe: measuring needs the card (--device cpu takes --check)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("gather probe: no CUDA device (pass --device cpu to --check the plain "
                         "version on the CPU)")
    device = torch.device(args.device)
    if args.check:
        for line in check(device, rows):
            print(line)
        return []
    results = []
    for table_rows in (PROBE_TABLE_ROWS, FLAGSHIP_TABLE_ROWS):
        r = measure(table_rows, rows, device)
        for arm in ("library", "kernel"):
            print(f"{arm:<8} table={table_rows:>11,} rows={rows:>11,}  {r[f'{arm}_ms']:8.3f} ms"
                  f"  {r[f'{arm}_ns_per_row']:6.3f} ns/row  bound {r['bound_ms']:.3f} ms"
                  f" (one sector per row {r['sector_bound_ms']:.3f} ms)")
        results.append(r)
    sys.stdout.flush()
    return results


if __name__ == "__main__":
    main()
