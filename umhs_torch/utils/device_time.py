"""Device time per call, by device kernel, under torch.profiler (the card
only). Used by the probe twins and by chip_smoke.py's kernel timers."""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Sequence

import torch


def kernel_name(key: str) -> str:
    """A device kernel's name from the profiler's key, without its return
    type, namespaces, template arguments and parameters."""
    key = key.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", key, maxsplit=1)[0].strip().split("::")[-1]


PROFILE_ATTEMPTS = 5  # profiles taken before a reading is given up


def device_ms_by_kernel(fn: Callable, between: Optional[Callable] = None,
                        keep: Optional[Sequence[str]] = None,
                        iters: int = 10) -> Optional[Dict[str, float]]:
    """Device ms per call of fn() by kernel name, under torch.profiler over
    `iters` calls; between(), when given, runs before each call, and then
    only the kernels named in `keep` (fn's own, from a run without it) are
    kept.

    The profiler was seen to drop device events now and then (a reading of
    0, or of one call in ten), in bursts. So a reading counts only when
    every device kernel in it ran a multiple of `iters` times; else it is
    taken again, up to PROFILE_ATTEMPTS times. If none is whole, the result
    is None and a line says so: no number known to be short is returned."""
    from torch.profiler import ProfilerActivity, profile

    def body():
        if between is not None:
            between()
        fn()

    def take() -> Dict[str, tuple]:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                body()
            torch.cuda.synchronize()
        return {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
                if "CUDA" in str(e.device_type)}

    body()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        many = take()
        if many and all(c % iters == 0 for c, _ in many.values()):
            break
    else:
        print(f"[device_time] torch.profiler dropped device events in all {PROFILE_ATTEMPTS} "
              f"profiles (kernel counts of the last: {sorted(c for c, _ in many.values())} "
              f"over {iters} calls); no reading")
        return None
    out: Dict[str, float] = {}
    for key, (_, us) in many.items():
        name = kernel_name(key)
        out[name] = out.get(name, 0.0) + us / iters / 1e3
    if between is not None:
        out = {k: v for k, v in out.items() if k in keep}
    return out
