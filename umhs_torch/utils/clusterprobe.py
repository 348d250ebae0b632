"""Cosine-similarity cluster probe for unsupervised material segmentation
(port of umhs_tpu/utils/clusterprobe.py): normalise rendered spectra and
endmembers, inner products F_hat @ C_hat^T, probs = softmax(alpha * ip), or
one-hot argmax when alpha is None."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim, keepdim=True), eps)


def cluster_probe(
    features: torch.Tensor,
    clusters: torch.Tensor,
    alpha: Optional[float] = 0.2,
    log_probs: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inner_products (P, K), probs (P, K)) of features (P, C) against
    cluster vectors (K, C)."""
    inner_products = _l2_normalize(features, dim=1) @ _l2_normalize(clusters, dim=1).T
    if alpha is None:
        probs = torch.nn.functional.one_hot(
            torch.argmax(inner_products, dim=1), clusters.shape[0]).float()
    elif log_probs:
        probs = torch.log_softmax(inner_products * alpha, dim=1)
    else:
        probs = torch.softmax(inner_products * alpha, dim=1)
    return inner_products, probs


# 15-colour class palette for segmentation images
CLASS_COLORS = (
    (0.49, 0.29, 0.95), (0.29, 0.95, 0.30), (0.95, 0.29, 0.47), (0.29, 0.66, 0.95),
    (0.86, 0.95, 0.29), (0.85, 0.29, 0.95), (0.29, 0.95, 0.66), (0.95, 0.46, 0.29),
    (0.29, 0.30, 0.95), (0.50, 0.95, 0.29), (0.95, 0.29, 0.69), (0.29, 0.88, 0.95),
    (0.95, 0.82, 0.29), (0.63, 0.29, 0.95), (0.29, 0.95, 0.43),
)


def label_to_rgb(labels: torch.Tensor) -> torch.Tensor:
    """Integer class labels (...,) -> palette colours (..., 3)."""
    colors = torch.tensor(CLASS_COLORS, dtype=torch.float32, device=labels.device)
    return colors[labels.long() % colors.shape[0]]
