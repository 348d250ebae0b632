"""trunc_exp, the density rectifier (port of umhs_tpu/ops/activations.py).

Forward only in this slice: exp of the pre-activation clamped to [-15, 15].
The clamp keeps an early large logit from overflowing f32 to inf, which
would poison the occupancy grid's EMA with NaN (inf * 0).
"""

from __future__ import annotations

import torch


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -15.0, 15.0))
