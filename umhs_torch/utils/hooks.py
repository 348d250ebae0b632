"""NaN and fault detection (port of umhs_tpu/utils/hooks.py).

The reference's `check_nan` pipeline flag maps to
torch.autograd.set_detect_anomaly (umhs_pipeline.py:77-78), and its
`nan_hook` forward hook to `checkify_nan`: the function runs, then its
outputs are checked. `assert_finite` checks every floating-point tensor or
array in a nested dict, list or tuple.
"""

from __future__ import annotations

import functools
from typing import Any, List

import numpy as np
import torch


def enable_nan_checks(enabled: bool = True) -> None:
    """Global NaN detection (the check_nan config flag): autograd's anomaly
    mode, which raises at the backward op that made a NaN."""
    torch.autograd.set_detect_anomaly(enabled)


def _leaves(tree: Any) -> List[Any]:
    """Leaves in jax.tree.leaves' order: dict values by sorted key."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def assert_finite(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError when a floating-point leaf holds a NaN or an
    infinity (one host sync per tensor leaf)."""
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(torch.isfinite(leaf.detach()).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not bool(np.isfinite(arr).all())
        if bad:
            raise FloatingPointError(f"non-finite values in {name} leaf {i}")


def checkify_nan(fn):
    """`fn` wrapped so that a non-finite output raises after the call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, getattr(fn, "__name__", "output"))
        return out

    return wrapper
