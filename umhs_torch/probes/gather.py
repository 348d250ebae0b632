"""Row-gather probe: the hand-written row gather P1 against torch.index_select
(the twin of scripts/probe_pallas_gather.py, whose arms were XLA's gather and
a Pallas DMA gather).

    python -m umhs_torch.probes.gather [--check] [--rows N] [--device cuda|cpu]

Arms, at the probe's shapes and on the flagship's hash table:
  library   torch.index_select(table, 0, idx), PyTorch's gather (the
            probe's XLA arm)
  kernel    P1, umhs_torch/csrc/row_gather.cu, which walks the table in
            slices so that the L2 holds the rows being read

Tables: the probe's 12,000,000 x 2 f32 (96 MB, more than the H100's 50 MB
L2; the JAX probe's comment says ~48 MB) and the flagship's L16xF2 2^19 table
of 6,098,108 x 2 f32 (48.8 MB, which nearly fits). Rows: 16,318,464 random
indices (254,976 compact samples x 64 tetrahedral lanes), or --rows N. Both
arms (and any others `measure` is given) are timed the same way and in
turns, with a warm L2 and a cold one: device time under torch.profiler with
each device kernel listed by name, and, warm, CUDA events around a batch of
calls. Each line gives them with ns per row and the bytes bound. Measuring
needs the card.

--check compares the kernel with the plain version bit for bit on the card,
on both tables at the probe's N and at the kernel's edge N; with --device
cpu it compares the plain version with a numpy take on the CPU. The device
is cuda unless --device cpu is given, and without a card the probe raises
rather than fall back.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.row_gather import WAVE, row_gather, row_gather_plain
from ..utils.device_time import device_ms_by_kernel

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


FLUSH_BYTES = 256 << 20  # written between calls for a cold L2 (the H100's is 50 MB)
ROUNDS = 2  # each arm timed this many times, in turns: A B C, then C B A


def batch_ms(fn: Callable, iters: int = 20) -> float:
    """ms per call of fn() from CUDA events around `iters` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    """The kernel and torch.index_select on one table, each timed the same
    way and in turns, with a warm L2 and with a cold one (FLUSH_BYTES written
    before each call): device ms under the profiler, with the ms of each
    device kernel the arm launched by name, and, warm, ms per call from CUDA
    events around a batch of calls.
    Each number is the mean of ROUNDS; the result holds the bounds too.
    Cold, the device time counts the kernels the arm launched warm (not the
    flush). A profile that lost device events (device_ms_by_kernel gives
    None) is left out of the means; where every one was, the arm's device
    numbers are None."""
    table, idx = make_case(table_rows, rows, device, seed)
    arms = {"kernel": lambda: row_gather(table, idx),
            "library": lambda: torch.index_select(table, 0, idx)}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    result: Dict[str, object] = {"table_rows": table_rows, "rows": rows, **bounds_ms(idx)}
    own: Dict[str, List[str]] = {}  # the kernels each arm launches, from its warm runs
    for l2, between in (("warm", None), ("cold", lambda: flush.fill_(1))):
        runs: Dict[str, List] = {name: [] for name in arms}
        calls: Dict[str, List[float]] = {name: [] for name in arms}
        for r in range(ROUNDS):
            for name in (list(arms) if r % 2 == 0 else list(arms)[::-1]):
                if between is not None and name not in own:
                    continue  # no warm reading named the arm's kernels
                by_kernel = device_ms_by_kernel(arms[name], between, own.get(name))
                if between is None:
                    calls[name].append(batch_ms(arms[name]))
                if by_kernel is None:
                    continue
                if between is None:
                    own[name] = sorted(set(own.get(name, [])) | set(by_kernel))
                runs[name].append((sum(by_kernel.values()), by_kernel))
        for name, got in runs.items():
            prefix = name if l2 == "warm" else f"{name}_cold"
            if l2 == "warm":
                result[f"{prefix}_batch_ms"] = float(np.mean(calls[name]))
            ms = float(np.mean([g[0] for g in got])) if got else None
            result[f"{prefix}_ms"] = ms
            result[f"{prefix}_kernels"] = ({k: float(np.mean([g[1].get(k, 0.0) for g in got]))
                                            for k in got[0][1]} if got else None)
            result[f"{prefix}_ns_per_row"] = ms * 1e6 / rows if got else None
            result[f"{prefix}_readings"] = len(got)
    del flush
    return result


def edge_rows() -> List[int]:
    """Row counts at the kernel's edges: 0, under a warp, the Pallas kernel's
    2048-row block +- 1, 8k +- 1 and a wave of csrc/row_gather.cu +- 1."""
    return [0, 1, 3, 4, 5, 2047, 2049, 8 * 127 - 1, 8 * 127 + 1, WAVE - 1, WAVE + 1,
            8 * WAVE + 1]


def check(device, rows: int = PROBE_ROWS) -> List[str]:
    """Bit-for-bit checks, with the table's last row first among the indices
    and its first row last; raises AssertionError on a mismatch. On the
    card: the kernel against the plain version on the probe's and the
    flagship's table, at `rows` rows and at every edge_rows() N. On the CPU:
    the plain version against numpy's take at 4096, 2049 and 1 rows."""
    lines = []
    if device.type == "cuda":
        cases = [(t, [rows] + edge_rows()) for t in (PROBE_TABLE_ROWS, FLAGSHIP_TABLE_ROWS)]
    else:
        cases = [(4096, [2 * 2048, 2049, 1])]
    for table_rows, counts in cases:
        table, all_idx = make_case(table_rows, max(counts), device)
        for n in counts:
            idx = all_idx[:n].clone()
            if n:
                idx[0] = table_rows - 1
            if n > 1:
                idx[-1] = 0
            if device.type == "cuda":
                got, want, arms = row_gather(table, idx), row_gather_plain(table, idx), \
                    "kernel/plain"
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
        print(f"table={table_rows:,} rows={rows:,}: bound {r['bound_ms']:.3f} ms (one sector "
              f"per row {r['sector_bound_ms']:.3f} ms)")
        for arm in ("kernel", "library"):
            for l2 in ("warm", "cold"):
                p = arm if l2 == "warm" else f"{arm}_cold"
                events = (f"; events {r[p + '_batch_ms']:8.3f} ms per call" if l2 == "warm"
                          else "")
                if r[p + "_ms"] is None:
                    print(f"  {arm:<8} {l2}: device not measured (every profile lost "
                          f"events){events}")
                    continue
                print(f"  {arm:<8} {l2}: device {r[p + '_ms']:8.3f} ms, {r[p + '_ns_per_row']:6.3f} "
                      f"ns/row{events}; kernels "
                      + ", ".join(f"{k} {v:.3f}" for k, v in r[p + "_kernels"].items()))
        results.append(r)
    sys.stdout.flush()
    return results


if __name__ == "__main__":
    main()
