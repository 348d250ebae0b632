"""Image and spectral quality metrics: PSNR, SSIM, SAM, RMSE
(port of umhs_tpu/utils/metrics.py:23-97).

Host numpy on full eval images, not in the training loop: PSNR at data range
1, SSIM with an 11x11 Gaussian window (sigma 1.5) in valid mode, channels
averaged, the spectral angle per pixel nan-averaged over pixels with a
non-zero spectrum, RMSE. LPIPS is not ported yet.
"""

from __future__ import annotations

import numpy as np


def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    return float(10.0 * np.log10(data_range**2 / max(mse, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 2-D filter over the first two axes, valid region only (the
    kernel is symmetric, so correlation and convolution agree)."""
    out = np.lib.stride_tricks.sliding_window_view(img, len(k), axis=0) @ k
    return np.lib.stride_tricks.sliding_window_view(out, len(k), axis=1) @ k


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0,
         k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM over the valid windows, averaged over channels."""
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    kern = _gaussian_kernel()
    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        mu_x = _filter2d_valid(x, kern)
        mu_y = _filter2d_valid(y, kern)
        sigma_x = _filter2d_valid(x * x, kern) - mu_x**2
        sigma_y = _filter2d_valid(y * y, kern) - mu_y**2
        sigma_xy = _filter2d_valid(x * y, kern) - mu_x * mu_y
        num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
        den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
        vals.append(np.mean(num / den))
    return float(np.mean(vals))


def sam(pred: np.ndarray, gt: np.ndarray, eps: float = 1e-8) -> float:
    """Spectral Angle Mapper: mean angle (radians) between per-pixel spectra;
    pixels where either spectrum is ~0 are left out (nan-mean)."""
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    dot = np.sum(pred * gt, axis=-1)
    denom = np.linalg.norm(pred, axis=-1) * np.linalg.norm(gt, axis=-1)
    ang = np.arccos(np.clip(dot / (denom + eps), -1.0, 1.0))
    return float(np.nanmean(np.where(denom < eps, np.nan, ang)))


def rmse(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.sqrt(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2)))


def mse2psnr(mse: float) -> float:
    """MSE -> PSNR for [0, 1] images."""
    return float(-10.0 * np.log10(max(float(mse), 1e-12)))
