"""Profiling and tracing (port of umhs_tpu/utils/profiler.py).

`time_function` records wall-clock times, printed as a report at process
exit (the reference's `@profiler.time_function`). `trace(log_dir)` runs its
block under torch.profiler, with the card's activity when the device is a
card, and writes a Chrome trace (chrome://tracing, Perfetto) into log_dir.
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch

from .. import resolve_device

_TIMINGS: Dict[str, list] = defaultdict(list)
_REGISTERED = False


def _print_report():
    if not _TIMINGS:
        return
    print("\n-- profiler report (wall clock) --")
    for name, times in sorted(_TIMINGS.items()):
        total = sum(times)
        print(f"  {name}: n={len(times)} total={total:.3f}s "
              f"mean={total / len(times) * 1e3:.1f}ms")


def time_function(fn):
    """Decorator recording wall-clock timings, reported at process exit."""
    global _REGISTERED
    if not _REGISTERED:
        atexit.register(_print_report)
        _REGISTERED = True

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        try:
            return fn(*args, **kwargs)
        finally:
            _TIMINGS[fn.__qualname__].append(time.time() - t0)

    return wrapper


@contextlib.contextmanager
def trace(log_dir: Optional[Path] = None, device="cuda"):
    """`with trace("profiles") as path: step()`: the block under
    torch.profiler (CPU activity, and CUDA activity on a card), its Chrome
    trace written to `path` under log_dir when the block ends. Raises when
    the card is asked for and absent."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir or "profiles")
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / f"trace-{os.getpid()}-{time.time_ns()}.json"
    with profile(activities=activities) as prof:
        yield path
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(path))
