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


def device_ms_by_kernel(fn: Callable, between: Optional[Callable] = None,
                        keep: Optional[Sequence[str]] = None,
                        iters: int = 10) -> Dict[str, float]:
    """Device ms per call of fn() by kernel name, under torch.profiler over
    `iters` calls; between(), when given, runs before each call, and then
    only the kernels named in `keep` (fn's own, from a run without it) are
    kept."""
    from torch.profiler import ProfilerActivity, profile

    def body():
        if between is not None:
            between()
        fn()

    body()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            body()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if "CUDA" in str(e.device_type):
            name = kernel_name(e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / iters / 1e3
    if between is not None:
        out = {k: v for k, v in out.items() if k in keep}
    return out
