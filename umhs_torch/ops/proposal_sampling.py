"""Proposal-network sampling, nerfacto's uniform -> PDF resampling
(port of umhs_tpu/ops/proposal_sampling.py).

Stratified bins in s-space, warped to t by the uniform-in-disparity map,
and PDF resampling by inverse CDF; the interlevel loss (a proposal's outer
measure over each final bin must bound the final weight) and the distortion
loss. Shapes are fixed: (R, N + 1) bin edges, (R, N) weights.

The JAX package draws its stratification jitter from a key; here it is an
argument, a (R, 1) tensor of uniform [0, 1) draws (the JAX package's
uniform(key, (R, 1))), or None for none. Its binary searches are
`torch.searchsorted` with the JAX tie rules. Per-row lookups index the
flattened tensor (`_take_rows`) rather than call `torch.gather`: on the card
the gradient of an index sums each entry's contributions in a fixed order
(a sort), where gather's adds them with float atomics, so a training run
repeats bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[r, idx[r, j]] for (R, N) x and (R, M) int64 idx -> (R, M)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None] * x.shape[1]
    return x.reshape(-1)[rows + idx]


def sdist_to_t(s: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """s in [0, 1] -> t in [near, far] with 1/t linear in s."""
    return 1.0 / ((1.0 - s) / near + s / far)


def uniform_bins(num_rays: int, num_samples: int, jitter: Optional[torch.Tensor] = None,
                 device=None) -> torch.Tensor:
    """Stratified s-space bin edges (R, N + 1) in [0, 1]: the interior edges
    shifted by (jitter - 0.5) / N per ray when `jitter` (R, 1) is given."""
    if jitter is not None:
        device = jitter.device
    edges = torch.linspace(0.0, 1.0, num_samples + 1, device=device)
    edges = edges.expand(num_rays, num_samples + 1)
    if jitter is not None:
        shift = (jitter - 0.5) * (1.0 / num_samples)
        interior = torch.clamp(edges[:, 1:-1] + shift, 0.0, 1.0)
        edges = torch.cat([edges[:, :1], interior, edges[:, -1:]], dim=1)
    return edges


def pdf_resample(bins: torch.Tensor, weights: torch.Tensor, num_samples: int,
                 jitter: Optional[torch.Tensor] = None, padding: float = 0.01) -> torch.Tensor:
    """Inverse-CDF resampling: (R, num_samples + 1) new edges concentrated
    where the weights (R, N) over `bins` (R, N + 1) are, with `padding` / N
    added to every weight. The quantiles are evenly spaced, shifted by
    (jitter - 0.5) / num_samples per ray when `jitter` (R, 1) is given.
    Each quantile u falls in the first bin i with cdf[i + 1] >= u (at most
    N - 1), as the JAX binary search puts it."""
    R, N = weights.shape
    w = weights + padding / N
    w = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros((R, 1), dtype=w.dtype, device=w.device),
                     torch.cumsum(w, dim=-1)], dim=-1)  # (R, N + 1), last ~1

    M = num_samples + 1
    u = torch.linspace(0.0, 1.0, M, device=w.device).expand(R, M)
    if jitter is not None:
        u = torch.clamp(u + (jitter - 0.5) * (1.0 / num_samples), 0.0, 1.0)
    idx = torch.searchsorted(cdf[:, 1:].detach().contiguous(), u.contiguous(), side="left")
    idx = torch.clamp_max(idx, N - 1)

    cdf_lo, cdf_hi = _take_rows(cdf, idx), _take_rows(cdf, idx + 1)
    bin_lo, bin_hi = _take_rows(bins, idx), _take_rows(bins, idx + 1)
    frac = torch.where(cdf_hi > cdf_lo, (u - cdf_lo) / (cdf_hi - cdf_lo + 1e-12),
                       torch.zeros_like(u))
    frac = torch.clamp(frac, 0.0, 1.0)
    edges = bin_lo + frac * (bin_hi - bin_lo)
    # monotone against fp edge cases: the running maximum, taken by index
    return _take_rows(edges, torch.cummax(edges.detach(), dim=1).indices)


def _searchsorted_rows(sorted_edges: torch.Tensor, x: torch.Tensor, side: str) -> torch.Tensor:
    """Per row r, the insertion index of x[r, j] into sorted_edges[r, :]
    (side as in numpy)."""
    return torch.searchsorted(sorted_edges.detach().contiguous(), x.detach().contiguous(),
                              side=side)


def _outer_measure(query_bins: torch.Tensor, src_bins: torch.Tensor,
                   src_weights: torch.Tensor) -> torch.Tensor:
    """The (src_bins, src_weights) histogram's outer measure over each query
    bin (mip-NeRF 360's inner_outer): the total weight of every source bin
    that overlaps the query interval."""
    R = src_weights.shape[0]
    cw = torch.cat([torch.zeros((R, 1), dtype=src_weights.dtype, device=src_weights.device),
                    torch.cumsum(src_weights, dim=-1)], dim=-1)  # (R, Ns + 1)
    last = src_bins.shape[1] - 1
    idx_lo = torch.clamp(_searchsorted_rows(src_bins, query_bins, "right") - 1, 0, last)
    idx_hi = torch.clamp(_searchsorted_rows(src_bins, query_bins, "left"), 0, last)
    cw_lo, cw_hi = _take_rows(cw, idx_lo), _take_rows(cw, idx_hi)
    return cw_hi[:, 1:] - cw_lo[:, :-1]


def interlevel_loss(prop_bins: torch.Tensor, prop_weights: torch.Tensor,
                    final_bins: torch.Tensor, final_weights: torch.Tensor) -> torch.Tensor:
    """Proposal supervision (mip-NeRF 360's lossfun_outer): the proposal's
    outer measure over each final bin must bound the final weight from above.
    The final bins and weights are detached, so gradients reach the proposal
    only. All bins share one (s-)space."""
    w = final_weights.detach()
    w_outer = _outer_measure(final_bins.detach(), prop_bins, prop_weights)  # (R, Nf)
    excess = torch.clamp_min(w - w_outer, 0.0)
    return torch.mean(torch.sum(excess ** 2 / (w + 1e-7), dim=-1))


def distortion_loss(bins: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360's distortion regulariser in s-space,
    sum_ij w_i w_j |m_i - m_j| + 1/3 sum_i w_i^2 (b_hi - b_lo)_i, in its
    O(N) prefix-sum form (the midpoints are sorted)."""
    mids = (bins[:, :-1] + bins[:, 1:]) / 2.0
    widths = bins[:, 1:] - bins[:, :-1]
    cw = torch.cumsum(weights, dim=-1)
    cwm = torch.cumsum(weights * mids, dim=-1)
    cw_prev = cw - weights
    cwm_prev = cwm - weights * mids
    pairwise = 2.0 * torch.sum(weights * (mids * cw_prev - cwm_prev), dim=-1)
    self_term = torch.sum(weights ** 2 * widths, dim=-1) / 3.0
    return torch.mean(pairwise + self_term)
