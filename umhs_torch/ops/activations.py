"""trunc_exp, the density rectifier (port of umhs_tpu/ops/activations.py).

Forward: exp of the pre-activation clamped to [-15, 15]. The clamp keeps an
early large logit from overflowing f32 to inf, which would poison the
occupancy grid's EMA with NaN (inf * 0). Backward: g * exp(clamp(x, -15,
15)), the JAX custom VJP, so a clamped pre-activation still gets a gradient
(autograd through the clamp would give it none).
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.exp(torch.clamp(x, -15.0, 15.0))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
