"""Volume-rendering weights and accumulation on fixed shapes
(port of umhs_tpu/ops/compositing.py).

Every ray carries a fixed lane of samples with a validity mask.
Transmittance is an exclusive cumulative sum of sigma * delta. Samples whose
alpha falls below `alpha_thre` neither emit nor attenuate, and samples behind
transmittance below `early_stop_eps` are dropped (nerfacc's visibility
filter). Per-ray sums over a ray-major compact buffer are prefix sums read
at segment boundaries.
"""

from __future__ import annotations

from typing import Union

import torch


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def render_weights(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    mask: torch.Tensor,
    alpha_thre: Union[float, torch.Tensor] = 0.0,
    early_stop_eps: float = 1e-4,
) -> torch.Tensor:
    """w_i = T_i * (1 - exp(-sigma_i * delta_i)) on (R, S); 0 on dropped lanes.
    alpha_thre may be a 0-dim tensor (min(0.01, mean(occs)) in the model)."""
    zero = torch.zeros((), dtype=sigmas.dtype, device=sigmas.device)
    delta = torch.clamp_min(t_ends - t_starts, 0.0)
    sigma_delta = torch.where(mask, sigmas * delta, zero)
    alphas = 1.0 - torch.exp(-sigma_delta)
    if not (isinstance(alpha_thre, (int, float)) and alpha_thre <= 0.0):
        keep = mask & (alphas.detach() >= alpha_thre)
        sigma_delta = torch.where(keep, sigma_delta, zero)
        alphas = torch.where(keep, alphas, zero)
    trans = torch.exp(-exclusive_cumsum(sigma_delta, dim=-1))
    if early_stop_eps > 0.0:
        alphas = torch.where(trans.detach() >= early_stop_eps, alphas, zero)
    return alphas * trans


def accumulate(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum_s w[r, s] * v[r, s, c]: (R, S), (R, S, C) -> (R, C)."""
    return torch.einsum("rs,rsc->rc", weights, values)


def segment_accumulate(
    weighted_values: torch.Tensor,
    ray_starts: torch.Tensor,
    ray_counts: torch.Tensor,
) -> torch.Tensor:
    """Per-ray sums over a ray-major compact buffer (B, C) whose rays own
    contiguous runs [start, start + count): inclusive prefix sum read at the
    run ends minus at the run starts. Returns (R, C)."""
    # scan along the last axis of the (C, B) transpose: CUDA's scan along a
    # leading axis of a (B, C) tensor ran ~40 ms per call at B = 2^17
    prefix = torch.cumsum(weighted_values.t(), dim=1)  # (C, B)
    last = prefix.shape[1] - 1
    ends = torch.clamp(ray_starts + ray_counts - 1, 0, last)
    end_vals = prefix[:, ends].t()
    start_vals = prefix[:, torch.clamp(ray_starts - 1, 0, last)].t()
    start_vals = torch.where((ray_starts > 0)[:, None], start_vals, torch.zeros_like(start_vals))
    out = end_vals - start_vals
    return torch.where((ray_counts > 0)[:, None], out, torch.zeros_like(out))


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    """Opacity per ray: (R, S) -> (R, 1)."""
    return torch.sum(weights, dim=-1, keepdim=True)


def render_depth_expected(
    weights: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    mask: torch.Tensor,
    eps: float = 1e-10,
) -> torch.Tensor:
    """sum(w * mid) / (sum(w) + eps), clipped to the batch's sample range
    (nerfstudio's expected depth, as the JAX package computes it)."""
    mids = (t_starts + t_ends) / 2.0
    depth = torch.sum(weights * mids, dim=-1, keepdim=True)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    depth = depth / (acc + eps)
    big = torch.finfo(mids.dtype).max
    mid_min = torch.amin(torch.where(mask, mids, torch.full_like(mids, big)))
    mid_max = torch.amax(torch.where(mask, mids, torch.full_like(mids, -big)))
    return torch.minimum(torch.maximum(depth, mid_min), mid_max)
